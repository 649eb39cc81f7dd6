"""Data parallelism over processes (counterpart of ``vaegan_tpu/parallel/mesh.py``).

The JAX package names a ``jax.sharding.Mesh`` of devices, annotates the batch
as sharded along its ``data`` axis and the state as replicated, and lets GSPMD
insert the collectives into one jitted step. PyTorch has no such compiler
pass, so the same program is written out here. A :class:`Mesh` is the world
of a ``torch.distributed`` process group, one process per device, each holding
a full copy of the state; :func:`make_parallel_train_step` builds the port's
step with this process's :class:`~vaegan_tpu_torch.ops.replica.Replica`, whose
collectives (global batch statistics, the loss shares' gradients summed in
one all-reduce per optimizer, the metrics) make the step compute what the
one-process step computes on the global batch, draws included
(``ops.replica``). A mesh of one process is the degenerate case, as in JAX:
no collective runs.

Where a JAX name returns a ``NamedSharding``, the port's returns what a
process holds: :func:`batch_sharding` the rows of the global batch,
:func:`replicated` all of them. Only ``num_model == 1`` exists: tensor
parallelism of the critic's dense head (``state_shardings``' model axis in
JAX) and spatial sharding are ROADMAP.md A.9 and A.10.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from vaegan_tpu_torch.config import Config
from vaegan_tpu_torch.ops.replica import Replica, rank_rows
from vaegan_tpu_torch.parallel import dist
from vaegan_tpu_torch.train.state import TrainState
from vaegan_tpu_torch.train.step import make_paper_train_step, make_train_step

_NOT_PORTED = {
    "tp": "tensor parallelism of the critic head (num_model > 1) is not ported yet "
          "(ROADMAP.md A.9)",
    "spatial": "spatial sharding of the batch (a batch_spec over H) is not ported yet "
               "(ROADMAP.md A.10)",
}


@dataclass(frozen=True)
class Mesh:
    """``num_data`` processes along the data axis (the world of ``group``),
    of which this one is ``rank``."""

    num_data: int
    rank: int = 0
    group: Optional[Any] = None

    @property
    def replica(self) -> Replica:
        return Replica(rank=self.rank, world=self.num_data, group=self.group)


def make_mesh(num_data: int = -1, num_model: int = 1, group=None) -> Mesh:
    """The data mesh over the processes of ``group`` (the default process
    group; without one, the world of this process alone). ``num_data`` -1
    takes every process; another value must be the world size."""
    if num_model != 1:
        raise NotImplementedError(_NOT_PORTED["tp"])
    world = dist.world_size(group)
    if num_data == -1:
        num_data = world
    if num_data != world:
        raise ValueError(f"make_mesh needs num_data={num_data} processes, the process group "
                         f"has {world}; start one process per device (torchrun "
                         "--nproc_per_node=N)")
    return Mesh(num_data=num_data, rank=dist.rank(group), group=group)


def batch_sharding(mesh: Mesh, batch_size: int, grad_accum: int = 1,
                   spatial_axis: Optional[str] = None) -> torch.Tensor:
    """The rows of a global batch of ``batch_size`` that this process holds
    (``ops.replica.rank_rows``): contiguous rows ``[r B/W, (r+1) B/W)``, or,
    with ``grad_accum`` k > 1, its rows of each of the k microbatches."""
    if spatial_axis is not None:
        raise NotImplementedError(_NOT_PORTED["spatial"])
    return rank_rows(batch_size, mesh.rank, mesh.num_data, grad_accum)


def shard_batch(mesh: Mesh, batch: torch.Tensor, grad_accum: int = 1) -> torch.Tensor:
    """This process's rows of a global batch (:func:`batch_sharding`)."""
    rows = batch_sharding(mesh, batch.shape[0], grad_accum)
    return batch.index_select(0, rows.to(batch.device))


def replicated(mesh: Mesh) -> slice:
    """What a process holds of a replicated tensor: all of it."""
    return slice(None)


def _state_tensors(state: TrainState) -> Dict[str, torch.Tensor]:
    """Every tensor of the state on the state's device, by name."""
    out = {f"generator.{k}": v for k, v in state.generator.state_dict().items()}
    out.update({f"critic.{k}": v for k, v in state.critic.state_dict().items()})
    for name, opt in (("opt_g", state.opt_g), ("opt_d", state.opt_d)):
        for i, st in enumerate(opt.state.values()):
            out.update({f"{name}.{i}.{k}": v for k, v in st.items()
                        if isinstance(v, torch.Tensor) and v.device.type != "cpu"})
    if state.g_ema is not None:
        out.update({f"g_ema.{k}": v for k, v in state.g_ema.items()})
    return out


def state_shardings(state: TrainState, mesh: Mesh) -> Dict[str, slice]:
    """Per state tensor, what a process holds of it: everything is replicated
    (no model axis, :func:`make_mesh`)."""
    return {k: replicated(mesh) for k in _state_tensors(state)}


def _checksums(tensors) -> torch.Tensor:
    return torch.stack([t.detach().double().sum() for t in tensors])


def replicate_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Make every process hold rank 0's state: its tensors are broadcast from
    rank 0 (one broadcast per dtype, through one flat buffer), in place, and a
    checksum of each tensor is compared across the processes, raising on any
    difference. A mesh of one process returns the state as it is."""
    if mesh.num_data == 1:
        return state
    tensors = list(_state_tensors(state).values())
    src = torch.distributed.get_global_rank(mesh.group, 0) if mesh.group is not None else 0
    with torch.no_grad():
        for dtype in sorted({t.dtype for t in tensors}, key=str):
            group = [t for t in tensors if t.dtype == dtype]
            flat = torch._utils._flatten_dense_tensors(group)
            torch.distributed.broadcast(flat, src=src, group=mesh.group)
            for t, v in zip(group, torch._utils._unflatten_dense_tensors(flat, group)):
                t.copy_(v)
        mine = _checksums(tensors)
        ref = mine.clone()
        torch.distributed.broadcast(ref, src=src, group=mesh.group)
        bad = (mine != ref).any().to(torch.int32).reshape(1)
        mesh.replica.all_reduce_(bad)
    if int(bad):
        raise RuntimeError("replicate_state: the processes' states differ after the broadcast")
    return state


def shard_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Place the state per :func:`state_shardings`: replicated on every
    process (:func:`replicate_state`)."""
    return replicate_state(state, mesh)


def _shard_inject(inject: Optional[dict], mesh: Mesh, grad_accum: int) -> Optional[dict]:
    """An ``inject`` of global-batch draws cut to this process's rows."""
    if not inject or mesh.num_data == 1:
        return inject

    def cut(v):
        if isinstance(v, dict):
            return {k: cut(m) for k, m in v.items()}
        return shard_batch(mesh, torch.as_tensor(v), grad_accum)

    return {k: cut(v) for k, v in inject.items()}


def make_parallel_train_step(cfg: Config, mesh: Mesh, do_g_update: bool = True,
                             batch_spec=None, do_gp: bool = True,
                             gp_lambda_scale: float = 1.0,
                             inject: Optional[Dict[str, object]] = None) -> Callable:
    """The data-parallel step: ``step(state, batch, seed) -> (state,
    metrics)`` with ``batch`` this process's rows of the global batch
    (:func:`batch_sharding`), the state replicated and updated in place, and
    the global metrics on every process. Every process passes the same
    ``seed``. ``cfg.optim.scheme == "three"`` builds the Larsen step, which has
    no penalty to skip (``do_gp=False`` raises). ``inject`` takes global-batch
    draws (``train.step``), cut to this process's rows. The state is
    replicated (there is no ``state_spec``); a ``batch_spec`` (spatial
    sharding) raises."""
    if batch_spec is not None:
        raise NotImplementedError(_NOT_PORTED["spatial"])
    inject = _shard_inject(inject, mesh, cfg.train.grad_accum)
    if cfg.optim.scheme == "three":
        if not do_gp:
            # the Larsen step has no GP term to skip — honoring the flag
            # silently would hand back the full paper step to a caller that
            # asked for a cheaper variant
            raise ValueError(
                "do_gp=False is meaningless for the three-optimizer paper "
                "scheme (no gradient penalty); lazy GP applies to the "
                "two-optimizer WGAN-GP step only")
        return make_paper_train_step(cfg, inject=inject, replica=mesh.replica)
    return make_train_step(cfg, do_g_update, inject=inject, do_gp=do_gp,
                           gp_lambda_scale=gp_lambda_scale, replica=mesh.replica)
