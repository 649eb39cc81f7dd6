"""Data x model parallelism over processes (counterpart of
``vaegan_tpu/parallel/mesh.py``).

The JAX package names a ``jax.sharding.Mesh`` of devices, annotates the batch
as sharded along its ``data`` axis (and H along the second axis: spatial
sharding) and the critic head's kernels along the second axis (tensor
parallelism), and lets GSPMD insert the collectives into one jitted step.
PyTorch has no such compiler pass, so the same program is written out here. A
:class:`Mesh` is ``num_data x num_model`` processes of a ``torch.distributed``
world (or of a group of it), one per device, process ``(d, m)`` at rank ``d
num_model + m`` of that group
(the JAX mesh's row-major order); :func:`make_parallel_train_step` builds the
port's step with this process's :class:`~vaegan_tpu_torch.ops.replica.Replica`,
whose collectives (global batch statistics, conv halos, the head's gathers, the
loss shares' gradients summed in one all-reduce per optimizer and axis, the
metrics) make the step compute what the one-process step computes on the
global batch, draws included (``ops.replica``). A 1 x 1 mesh is the degenerate
case, as in JAX: no collective runs.

Where a JAX name returns a ``NamedSharding``, the port's returns what a
process holds: :func:`batch_sharding` a :class:`BatchSpec` (rows, and an H
stripe with a spatial axis), :func:`state_shardings` per state tensor
``slice(None)`` (replicated) or the rows of its first axis that the process
holds (the critic head's kernels under tensor parallelism). The state is
placed once, by :func:`shard_state`, and a step runs on the state as placed
(there is no ``state_spec``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from vaegan_tpu_torch.config import Config
from vaegan_tpu_torch.models.networks import check_stripes
from vaegan_tpu_torch.ops.replica import Replica, rank_rows
from vaegan_tpu_torch.parallel import dist
from vaegan_tpu_torch.train.state import TrainState, tp_linears
from vaegan_tpu_torch.train.step import make_paper_train_step, make_train_step


@dataclass(frozen=True)
class Mesh:
    """``num_data x num_model`` processes, of which this one is ``(rank,
    model_rank)``. ``group`` is the data axis through this process (the whole
    world when ``num_model`` is 1), ``model_group`` the model axis through it,
    ``mesh_group`` all of them (``None``: the default process group)."""

    num_data: int
    rank: int = 0
    group: Optional[Any] = None
    num_model: int = 1
    model_rank: int = 0
    model_group: Optional[Any] = None
    mesh_group: Optional[Any] = None
    axis_names: Tuple[str, str] = ("data", "model")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, (self.num_data, self.num_model)))

    @property
    def global_rank(self) -> int:
        """This process's rank in the mesh's group (the global rank over the
        default group)."""
        return self.rank * self.num_model + self.model_rank

    def replica_for(self, spatial: bool = False) -> Replica:
        """This process's replica, with H split over the model axis when
        ``spatial``."""
        return Replica(rank=self.rank, world=self.num_data, group=self.group,
                       model_rank=self.model_rank, num_model=self.num_model,
                       model_group=self.model_group,
                       mesh_group=self.mesh_group if self.num_model > 1 else self.group,
                       spatial=spatial and self.num_model > 1)

    @property
    def replica(self) -> Replica:
        """This process's replica without a spatial axis."""
        return self.replica_for(False)


def make_mesh(num_data: int = -1, num_model: int = 1, data_axis: str = "data",
              model_axis: str = "model", group=None) -> Optional[Mesh]:
    """The ``num_data x num_model`` mesh over the processes of ``group`` (the
    default process group; without one, the world of this process alone),
    process ``(d, m)`` being rank ``d num_model + m`` of ``group``.
    ``num_data`` -1 takes every process over ``num_model``; the product must
    be the group's size. ``data_axis`` / ``model_axis`` name the axes, as in
    JAX: a spatial ``batch_spec`` names the second, and tensor parallelism
    shards over the axis ``state_shardings`` names (``"model"``).

    With a model axis every process of the default group must call this with
    the same arguments, members of ``group`` or not: the mesh's groups are made
    by all of them (``dist.mesh_groups``), and a process outside ``group``
    gets ``None``."""
    ranks = dist.group_ranks(group) if group is not None and num_model > 1 else None
    world = len(ranks) if ranks is not None else dist.world_size(group)
    if num_model < 1 or world % num_model:
        raise ValueError(f"make_mesh: num_model={num_model} does not divide the {world} "
                         "processes of the group")
    if num_data == -1:
        num_data = world // num_model
    if num_data * num_model != world:
        raise ValueError(f"make_mesh needs {num_data}x{num_model}={num_data * num_model} "
                         f"processes, the process group has {world}; start one process per "
                         "device (torchrun --nproc_per_node=N)")
    names = (data_axis, model_axis)
    r = dist.rank(group)
    if num_model == 1:
        return Mesh(num_data=num_data, rank=r, group=group, axis_names=names)
    data_groups, model_groups = dist.mesh_groups(num_data, num_model, ranks)
    if r < 0:
        return None
    d, m = divmod(r, num_model)
    return Mesh(num_data=num_data, rank=d, group=data_groups[m], num_model=num_model,
                model_rank=m, model_group=model_groups[d], mesh_group=group, axis_names=names)


@dataclass(frozen=True)
class BatchSpec:
    """How a process cuts an NHWC global batch: its rows (the data axis), and
    its stripe of H when ``spatial`` (the model axis)."""

    spatial: bool = False


def batch_sharding(mesh: Mesh, data_axis: str = "data",
                   spatial_axis: Optional[str] = None) -> BatchSpec:
    """Batches cut along the rows over ``data_axis``, and along H over
    ``spatial_axis`` when given (the second axis of the mesh): the JAX
    package's ``P(data, spatial, None, None)``."""
    if data_axis != mesh.axis_names[0]:
        raise ValueError(f"the mesh's data axis is {mesh.axis_names[0]!r}, not {data_axis!r}")
    if spatial_axis is not None and spatial_axis != mesh.axis_names[1]:
        raise ValueError(f"the mesh's second axis is {mesh.axis_names[1]!r}, not "
                         f"{spatial_axis!r}")
    return BatchSpec(spatial=spatial_axis is not None)


def shard_batch(mesh: Mesh, batch: torch.Tensor, grad_accum: int = 1,
                spec: Optional[BatchSpec] = None) -> torch.Tensor:
    """This process's part of an NHWC global batch: rows ``[d B/D, (d+1)
    B/D)`` (``ops.replica.rank_rows``; with ``grad_accum`` k > 1 its rows of
    each of the k microbatches), and its H stripe under a spatial ``spec``."""
    rows = rank_rows(batch.shape[0], mesh.rank, mesh.num_data, grad_accum)
    out = batch.index_select(0, rows.to(batch.device))
    if spec is not None and spec.spatial:
        out = mesh.replica_for(True).stripe(out, 1)
    return out


def replicated(mesh: Mesh) -> slice:
    """What a process holds of a replicated tensor: all of it."""
    return slice(None)


def _state_tensors(state: TrainState) -> Dict[str, torch.Tensor]:
    """Every tensor of the state on the state's device, by name (optimizer
    state under the name of its parameter)."""
    out = {}
    for net in ("generator", "critic"):
        module = getattr(state, net)
        out.update({f"{net}.{k}": v for k, v in module.state_dict().items()})
    for name, opt, module in (("opt_g", state.opt_g, state.generator),
                              ("opt_d", state.opt_d, state.critic)):
        for pname, p in module.named_parameters():
            for k, v in opt.state.get(p, {}).items():
                if isinstance(v, torch.Tensor) and v.dim() > 0:    # not a step count
                    out[f"{name}.{pname}.{k}"] = v
    if state.g_ema is not None:
        out.update({f"g_ema.{k}": v for k, v in state.g_ema.items()})
    return out


def state_shardings(state: TrainState, mesh: Mesh, model_axis: str = "model") -> Dict[str, slice]:
    """Per state tensor, what this process holds of it: ``slice(None)``
    (replicated), or, when the mesh's axis ``model_axis`` has M > 1
    processes, for each critic ``linear_*`` kernel whose output width divides
    by M (the JAX rule, ``mesh.py:70-93``), the rows ``[m out/M, (m+1)
    out/M)`` of the torch ``[out, in]`` weight and of its optimizer state;
    biases stay replicated."""
    m_size = mesh.shape.get(model_axis, 1)
    rows = {}
    if m_size > 1:
        for name, lin in tp_linears(state.critic, m_size):
            rows[f"critic.{name}.weight"] = rows[f"opt_d.{name}.weight"] = \
                lin.rows(mesh.model_rank, m_size)
    out = {}
    for k, v in _state_tensors(state).items():
        # the kernel, and its optimizer state of the kernel's shape (not a step count)
        key = k.rsplit(".", 1)[0] if k.startswith("opt_d.") and v.dim() == 2 else k
        out[k] = rows.get(key, slice(None))
    return out


def _checksums(tensors) -> torch.Tensor:
    return torch.stack([t.detach().double().sum() for t in tensors])


def _broadcast(tensors, src: int, group, replica: Replica, over: str) -> bool:
    """Broadcast ``tensors`` from global rank ``src`` over ``group`` (one flat
    buffer per dtype), in place; whether every process then holds the same
    checksums (compared over the axis ``over``)."""
    with torch.no_grad():
        for dtype in sorted({t.dtype for t in tensors}, key=str):
            part = [t for t in tensors if t.dtype == dtype]
            flat = torch._utils._flatten_dense_tensors(part)
            torch.distributed.broadcast(flat, src=src, group=group)
            for t, v in zip(part, torch._utils._unflatten_dense_tensors(flat, part)):
                t.copy_(v)
        mine = _checksums(tensors) if tensors else torch.zeros(1)
        ref = mine.clone()
        torch.distributed.broadcast(ref, src=src, group=group)
        bad = (mine != ref).any().to(torch.int32).reshape(1).to(mine.device)
        replica.all_reduce_(bad, over)
    return not int(bad)


def replicate_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Make every process hold process (0, 0)'s state: its replicated tensors
    are broadcast from global rank 0 over the mesh, the critic head's slices
    of a state already split by :func:`shard_state` from data row 0 of each
    model index over the data axis (one broadcast per dtype through one flat
    buffer, in place), and a checksum of each tensor is compared across the
    processes, raising on any difference. A 1 x 1 mesh returns the state as it
    is."""
    if mesh.num_data * mesh.num_model == 1:
        return state
    names = _state_tensors(state)
    split = {k for k, v in state_shardings(state, mesh).items()
             if v != slice(None) and _is_cut(state, k)}
    replica = mesh.replica
    group = mesh.mesh_group if mesh.num_model > 1 else mesh.group
    src = torch.distributed.get_global_rank(group, 0) if group is not None else 0
    ok = _broadcast([v for k, v in names.items() if k not in split], src, group, replica,
                    "mesh")
    if mesh.num_data > 1 and split:
        ok &= _broadcast([names[k] for k in sorted(split)],
                         torch.distributed.get_global_rank(mesh.group, 0), mesh.group,
                         replica, "data")
    if not ok:
        raise RuntimeError("replicate_state: the processes' states differ after the broadcast")
    return state


def _is_cut(state: TrainState, key: str) -> bool:
    """Whether the state tensor ``key`` (a critic head kernel or its optimizer
    state) already holds a slice."""
    name = key.split(".")[1]
    return state.critic.get_submodule(name).tp[1] > 1


def shard_state(state: TrainState, mesh: Mesh, model_axis: str = "model") -> TrainState:
    """Place the state per :func:`state_shardings`: replicated on every
    process (:func:`replicate_state`), then, with tensor parallelism, each
    critic head kernel and its optimizer state cut to this process's rows
    (``layers.Linear.shard``), in place."""
    state = replicate_state(state, mesh)
    m_size = mesh.shape.get(model_axis, 1)
    if m_size > 1:
        for _, lin in tp_linears(state.critic, m_size):
            if lin.tp[1] == 1:
                lin.shard(mesh.model_rank, m_size, state.opt_d)
    return state


def _cut_inject(inject: Optional[dict], mesh: Mesh, replica: Replica,
                grad_accum: int) -> Optional[dict]:
    """An ``inject`` of global-batch draws cut to this process's rows and,
    under spatial sharding, its stripe of each draw over H: ``eps`` and
    ``z_p`` (NHWC), the generator's elementwise masks (NCHW); ``alpha`` and the
    critic's channel masks are per sample."""
    if not inject or not replica.parallel:
        return inject

    def cut(v, h_dim):
        rows = shard_batch(mesh, torch.as_tensor(v), grad_accum)
        return rows if h_dim is None else replica.stripe(rows, h_dim)

    out = {}
    for k, v in inject.items():
        if isinstance(v, dict):
            out[k] = {n: cut(m, 2 if torch.as_tensor(m).shape[2] > 1 else None)
                      for n, m in v.items()}
        else:
            out[k] = cut(v, 1 if k in ("eps", "z_p") else None)
    return out


def make_parallel_train_step(cfg: Config, mesh: Mesh, do_g_update: bool = True,
                             batch_spec: Optional[BatchSpec] = None, do_gp: bool = True,
                             gp_lambda_scale: float = 1.0,
                             inject: Optional[Dict[str, object]] = None) -> Callable:
    """The parallel step: ``step(state, batch, seed) -> (state, metrics)``
    with ``batch`` this process's part of the global batch (:func:`shard_batch`
    with the same ``batch_spec``), the state placed by :func:`shard_state` and
    updated in place, and the global metrics on every process. Every process
    passes the same ``seed``. ``batch_spec`` (:func:`batch_sharding`) with a
    spatial axis splits H over the model axis: the stripe count must divide
    every stage's H (``ValueError`` naming the stage).
    ``cfg.optim.scheme == "three"`` builds the Larsen step, which has no
    penalty to skip (``do_gp=False`` raises). ``inject`` takes global-batch
    draws (``train.step``), cut to this process's rows and stripe."""
    spatial = batch_spec is not None and batch_spec.spatial
    if spatial:
        check_stripes(cfg, mesh.num_model)
    replica = mesh.replica_for(spatial)
    inject = _cut_inject(inject, mesh, replica, cfg.train.grad_accum)
    if cfg.optim.scheme == "three":
        if not do_gp:
            # the Larsen step has no GP term to skip — honoring the flag
            # silently would hand back the full paper step to a caller that
            # asked for a cheaper variant
            raise ValueError(
                "do_gp=False is meaningless for the three-optimizer paper "
                "scheme (no gradient penalty); lazy GP applies to the "
                "two-optimizer WGAN-GP step only")
        return make_paper_train_step(cfg, inject=inject, replica=replica)
    return make_train_step(cfg, do_g_update, inject=inject, do_gp=do_gp,
                           gp_lambda_scale=gp_lambda_scale, replica=replica)
