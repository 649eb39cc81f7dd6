"""Data-parallel training entry (counterpart of ``vaegan_tpu/parallel/train.py``):
the mesh, the placed state, the parallel step variants and the standard loop,
wired. With ``cfg.parallel.num_model`` M > 1 the mesh is ``num_data x M`` and
the critic head's kernels are split over the model axis (tensor parallelism,
``parallel.shard_state``), as the JAX package does through the config; the
batch is split by rows only.

    from vaegan_tpu_torch.parallel.train import train_data_parallel
    state, logger = train_data_parallel(preset("vaegan_256_dp"))

Run one process per device, each calling this function: ``torchrun
--nproc_per_node=N -m vaegan_tpu_torch.cli train --dp ...`` (or a process of its
own with no ``torchrun`` environment: the world of one, as a one-device JAX
mesh). Without a process group it starts one (``parallel.dist.initialize``:
NCCL on CUDA, gloo on the CPU). Each process reads its rows of every global
batch from the rank-sharded host loader (``drop_last``: a partial batch cannot
be split) or, with ``data.hbm_cache``, gathers the same rows from a copy of the
dataset staged on its own card (``data.pipeline.DeviceDataLoader``), in any
world: the JAX package stages the dataset once for the devices of its one
process, the port once a process.
"""

from __future__ import annotations

from typing import Optional, Tuple

from vaegan_tpu_torch.config import Config
from vaegan_tpu_torch.data.pipeline import make_loader
from vaegan_tpu_torch.parallel import dist
from vaegan_tpu_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    make_parallel_train_step,
    shard_state,
)
from vaegan_tpu_torch.train.loop import train
from vaegan_tpu_torch.train.state import TrainState, create_train_state
from vaegan_tpu_torch.train.step import make_step_variants
from vaegan_tpu_torch.utils.metrics import MetricsLogger


def train_data_parallel(
    cfg: Config,
    loader=None,
    logger: Optional[MetricsLogger] = None,
    mesh: Optional[Mesh] = None,
    resume: bool = False,
    device="cuda",
) -> Tuple[TrainState, MetricsLogger]:
    """Train ``cfg`` data-parallel over the processes of the default group
    (``mesh`` overrides it) on this process's device (``"cuda"``: the device
    ``cuda:LOCAL_RANK``; ``"cpu"`` with gloo). Returns this process's
    ``(state, logger)``; the states of all processes are equal (each model
    index holding its own rows of the critic head's kernels)."""
    if mesh is None:
        dev = (dist.local_device(device) if dist.is_initialized()
               else dist.initialize(device=device))
        p = cfg.parallel
        mesh = make_mesh(num_data=p.num_data, num_model=p.num_model, data_axis=p.data_axis,
                         model_axis=p.model_axis)
    else:
        dev = dist.local_device(device)
    n_data, k = mesh.num_data, cfg.train.grad_accum
    if cfg.data.batch_size % (n_data * k) != 0:
        raise ValueError(
            f"global batch {cfg.data.batch_size} must be divisible by the data-axis size "
            f"({n_data}) times grad_accum ({k})")
    if dev.type == "cuda":
        # one process compiles the kernels; the others load what it built
        from vaegan_tpu_torch.ops import _build
        if mesh.global_rank == 0:
            _build.build_all()
        dist.barrier(mesh.mesh_group if mesh.num_model > 1 else mesh.group)
    if loader is None:
        loader = make_loader(cfg.data, seed=cfg.train.seed, drop_last=True, device=dev,
                             process_index=mesh.rank, process_count=n_data, microbatches=k)

    state = shard_state(create_train_state(cfg, device=dev), mesh,
                        model_axis=cfg.parallel.model_axis)
    if cfg.optim.scheme == "three":
        # the paper step has no critic-only variant; build it once
        step_g = make_parallel_train_step(cfg, mesh, do_g_update=True)
        step_fns = {(True, True): step_g, (False, True): step_g}
    else:
        step_fns = make_step_variants(
            cfg, lambda do_g, do_gp, scale: make_parallel_train_step(
                cfg, mesh, do_g_update=do_g, do_gp=do_gp, gp_lambda_scale=scale))
    return train(cfg, loader=loader, state=state, logger=logger, step_fns=step_fns,
                 resume=resume, mesh=mesh)
