"""Training loop (port of ``vaegan_tpu/train/loop.py``; the reference's
``train_network_wgan``), in the JAX loop's event order:

- the sample folder is wiped at the start of a fresh run (kept on resume);
- the critic updates every batch, the generator every ``n_critics``-th batch of
  each epoch (``i`` restarts each epoch); under lazy GP (``gp_every > 1``) the
  penalty runs on every ``gp_every``-th global step; under ``optim.scheme =
  "three"`` the one paper step runs on every batch (``n_critics`` does not
  apply);
- with ``grad_accum > 1`` the default loader drops a partial last batch (it
  could not be cut into microbatches);
- every ``sample_interval`` batches a 5x5 grid of the step's own generated
  images is written as ``{batches_done}.png``, regenerated BEFORE the step from
  the same seed (:func:`make_sampler`), so no image leaves the card on other
  steps;
- metric dicts stay on the device (:class:`MetricsLogger`); the NaN guard reads
  them at the flush cadence only;
- checkpoints every ``checkpoint_every`` steps and at the end; ``resume``
  continues from the latest one, replaying the loader's shuffle stream instead
  of decoding completed batches.

The host syncs of a run are the metric flush, the NaN guard at that cadence,
the grid write and the checkpoint save; a step itself never waits for the card.
Each is counted where it copies (``utils.profiling.count("host_sync")``: the
flush's copy, the grid's write, a save that writes), and each global step is a
``loop.step`` span (``step=global_step``) over ``loop.feed``, ``loop.sample``,
``step``, ``loop.nan_guard``, ``loop.grid`` and ``loop.checkpoint``. A
``loop.step`` that runs no step (the ``loop.feed`` that finds an epoch done, a
batch skipped on resume, a resumed run already at its budget) is tagged
``step=None``, so no two carry one step's id.

Data parallelism (``mesh``, ``parallel.train_data_parallel``): every process
runs this loop over its rows of each global batch with the same step seeds,
and its steps report the global metrics, so every process takes the same NaN
guard decision and issues the same collectives in the same order. The sinks,
the grids (gathered from every data row's rows) and the checkpoint writes are
process 0's, with a barrier after each save; every process restores. Under
tensor parallelism the processes of data row 0 gather the critic head's
slices for each save (``checkpoint``).

Per-step seeds. The JAX loop draws a step's randomness from
``fold_in(key(seed), global_step)``. The port's step takes an int (it seeds a
CPU ``torch.Generator`` for the fused kernels' seeds and one on the device for
the rest), and :func:`step_seed` gives it: splitmix64's finalizer over
``seed * 2**32 + global_step`` (both taken modulo 2**32); an accumulating step
derives its microbatches' seeds from it (``step.micro_seed``). It is a pure function
of ``(cfg.train.seed, global_step)``, so a resumed run draws what an
uninterrupted run draws, and on the CPU the two are equal bit for bit. The bits
are not ``fold_in``'s: the port's draws are Philox and torch's generators.
"""

from __future__ import annotations

import shutil
import time
from pathlib import Path
from typing import Callable, Iterable, Optional, Tuple

import torch

from vaegan_tpu_torch.config import Config
from vaegan_tpu_torch.data.pipeline import device_prefetch, make_loader
from vaegan_tpu_torch.models.layers import precision
from vaegan_tpu_torch.ops.replica import LOCAL, Replica
from vaegan_tpu_torch.parallel import dist
from vaegan_tpu_torch.train.state import DTYPES, TrainState, create_train_state, resolve_device
from vaegan_tpu_torch.train.step import (
    kept_buffers,
    lazy_gp_enabled,
    make_paper_train_step,
    make_step_variants,
    make_train_step,
    micro_seed,
    step_seed,
)
from vaegan_tpu_torch.utils.metrics import MetricsLogger
from vaegan_tpu_torch.utils.profiling import count, span


class TrainingDiverged(RuntimeError):
    """Raised by the opt-in NaN guard (``cfg.train.nan_check``)."""


def make_sampler(cfg: Config, replica: Replica = LOCAL) -> Callable:
    """``sample(state, batch, seed)`` -> the ``gen_imgs`` that ``step(state,
    batch, seed)`` is about to train on (with ``grad_accum > 1``, those of
    microbatch 0, from its own seed, as the JAX sampler draws); in a
    data-parallel run (``replica``) this process's rows of them, from a forward
    with the step's global statistics and draws.

    The step seeds a CPU generator (the fused kernels' seeds) and a device
    generator (masks, noise) from ``seed``, and its generator forward is their
    first consumer, in both schemes; the sampler seeds the same two and runs the
    same train-mode forward, so it replays that forward draw for draw. Train-mode
    BN writes its running statistics in place, so the sampler runs on clones of
    the generator's buffers (``step.kept_buffers``): the state is left bitwise as
    it was. The fused kernels it launches are counted in ``fused.LAUNCHES`` like
    any other launch.
    """
    dtype = DTYPES[cfg.train.dtype]
    k = cfg.train.grad_accum

    @torch.no_grad()
    def sample(state: TrainState, batch: torch.Tensor, seed: int) -> torch.Tensor:
        if k > 1:
            seed, batch = micro_seed(seed, 0), batch[: batch.shape[0] // k]
        seeds = torch.Generator().manual_seed(seed)
        rng = torch.Generator(device=batch.device).manual_seed(seed)
        with kept_buffers(state.generator), precision(dtype):
            out = state.generator(batch, train=True, generator=rng, seeds=seeds,
                                  replica=replica)
        return out[0] if cfg.generator.is_vae else out

    return sample


def _device(state: TrainState) -> torch.device:
    return next(state.generator.parameters()).device


def _gather_rows(replica: Replica, t: torch.Tensor) -> torch.Tensor:
    """The data axis's rows of a tensor, concatenated in rank order."""
    if replica.world == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(replica.world)]
    torch.distributed.all_gather(parts, t.contiguous(), group=replica.group)
    return torch.cat(parts)


def train(
    cfg: Config,
    loader: Optional[Iterable] = None,
    state: Optional[TrainState] = None,
    logger: Optional[MetricsLogger] = None,
    step_fns: Optional[object] = None,
    resume: bool = False,
    device="cuda",
    mesh=None,
) -> Tuple[TrainState, MetricsLogger]:
    """Run ``cfg.train.n_epochs`` of training; returns ``(final_state, logger)``.

    ``device``: where a new state and the default loader live (``"cuda"`` unless
    the caller asks for ``"cpu"``); a given ``state`` decides it instead.
    ``step_fns``: step overrides, either a ``(step_with_g, step_d_only)`` tuple
    or a dict keyed by ``(do_g_update, do_gp)`` (required when
    ``cfg.train.gp_every > 1``; under ``optim.scheme="three"`` only the
    ``(True, True)`` step runs); each is ``step(state, batch, seed) -> (state,
    metrics)``. ``resume``: restore the latest checkpoint under
    ``cfg.train.checkpoint_dir`` and continue after its step.
    ``cfg.train.rng_impl`` names a JAX PRNG and is ignored (see
    :func:`step_seed`). ``mesh``: a ``parallel.Mesh`` for a data-parallel run
    (module docstring), given with its ``loader``, ``state`` and ``step_fns``
    (``parallel.train_data_parallel`` builds them); a new ``logger`` then has
    no sink on ranks other than 0.
    """
    tcfg = cfg.train
    replica = LOCAL if mesh is None else mesh.replica
    lead = replica.lead
    paper = cfg.optim.scheme == "three"
    dev = resolve_device(device) if state is None else _device(state)
    if loader is None:
        # a partial last batch cannot be cut into grad_accum microbatches
        loader = make_loader(cfg.data, seed=tcfg.seed, device=dev,
                             drop_last=True if tcfg.grad_accum > 1 else None)
    if state is None:
        state = create_train_state(cfg, device=dev)
    if logger is None:
        logger = MetricsLogger(sinks=None if lead else [], flush_every=tcfg.log_every)

    lazy_gp = lazy_gp_enabled(cfg)
    if step_fns is None and paper:
        steps = {(True, True): make_paper_train_step(cfg)}
    elif step_fns is None:
        steps = make_step_variants(cfg, lambda do_g, do_gp, scale: make_train_step(
            cfg, do_g, do_gp=do_gp, gp_lambda_scale=scale))
    elif isinstance(step_fns, dict):
        steps = step_fns
    else:
        if lazy_gp:
            raise ValueError(
                "cfg.train.gp_every > 1 requires step_fns keyed by "
                "(do_g_update, do_gp), got a 2-tuple")
        step_g, step_d = step_fns
        steps = {(True, True): step_g, (False, True): step_d}
    need = {(True, True)} if paper else {(True, True), (False, True)} | (
        {(True, False), (False, False)} if lazy_gp else set())
    missing = need - set(steps)
    if missing:
        raise ValueError(
            f"step_fns is missing (do_g_update, do_gp) variants {sorted(missing)} "
            f"required by this config (gp_every={tcfg.gp_every})")

    ckpt = None
    start_step = 0
    if tcfg.checkpoint_dir:
        from vaegan_tpu_torch.checkpoint import CheckpointManager
        ckpt = CheckpointManager(tcfg.checkpoint_dir)
        if resume and ckpt.latest_step() is not None:
            # None: the probe could not read the checkpoint; trust the flags and
            # let restore() check the structure
            saved_ema = ckpt.saved_has_g_ema()
            if saved_ema is True and state.g_ema is None:
                raise ValueError(
                    f"checkpoint at {tcfg.checkpoint_dir} carries a generator "
                    "EMA; pass the same ema_decay (--ema-decay) to resume")
            if saved_ema is False and state.g_ema is not None:
                # a checkpoint from before EMA tracking: restore without it and
                # start the average from the restored params
                state = ckpt.restore(state.replace(g_ema=None))
                state.g_ema = {k: p.detach().clone()
                               for k, p in state.generator.named_parameters()}
            else:
                state = ckpt.restore(state)
            start_step = state.step

    sample_dir = Path(tcfg.sample_dir)
    if lead:
        if start_step == 0:
            # a fresh run wipes the folder like the reference; a resumed one keeps
            # the interrupted run's grids, which the skipped steps would not write
            shutil.rmtree(sample_dir, ignore_errors=True)
        sample_dir.mkdir(parents=True, exist_ok=True)
    sampler = make_sampler(cfg, replica)

    n_batches = len(loader) if hasattr(loader, "__len__") else -1
    global_step = 0
    nan_checked = 0
    budget_hit = False
    t0 = time.time()
    for epoch in range(tcfg.n_epochs):
        if budget_hit:
            break
        # resume without decoding: whole completed epochs replay only the
        # shuffle stream, a partial one opens at its batch offset (a loader
        # without these hooks is decoded and skipped)
        skip_in_epoch = 0
        if global_step < start_step and n_batches > 0:
            if global_step + n_batches <= start_step and hasattr(loader, "skip_epoch"):
                loader.skip_epoch()
                global_step += n_batches
                continue
            skip_in_epoch = min(start_step - global_step, n_batches)
        batch_offset = 0
        if skip_in_epoch and hasattr(loader, "iter_batches"):
            source = loader.iter_batches(skip_in_epoch)
            global_step += skip_in_epoch
            batch_offset = skip_in_epoch
        else:
            source = iter(loader)
        it = device_prefetch(source, dev, depth=cfg.data.prefetch)
        i = batch_offset
        while True:
            with span("loop.step", step=global_step) as looped:
                with span("loop.feed"):
                    batch = next(it, None)
                if batch is None:
                    looped.tag(step=None)
                    break
                if global_step < start_step:  # decode-and-skip fallback
                    looped.tag(step=None)
                    global_step += 1
                    i += 1
                    continue
                if tcfg.max_steps is not None and global_step >= tcfg.max_steps:
                    # checked BEFORE a step: a resumed run already at its budget
                    # must not run (and save) another one
                    looped.tag(step=None)
                    budget_hit = True
                    break
                seed = step_seed(tcfg.seed, global_step)
                do_g = (i % tcfg.n_critics) == 0
                batches_done = epoch * n_batches + i if n_batches > 0 else global_step
                sample_imgs = None
                if tcfg.sample_interval > 0 and batches_done % tcfg.sample_interval == 0:
                    with span("loop.sample"):
                        sample_imgs = sampler(state, batch, seed)
                do_gp = (not lazy_gp) or (global_step % tcfg.gp_every == 0)
                step = steps[(True, True)] if paper else steps[(do_g, do_gp)]
                with span("step"):
                    state, metrics = step(state, batch, seed)
                logger.log(epoch, tcfg.n_epochs, i, n_batches, metrics)
                if tcfg.nan_check and (global_step + 1) % logger.flush_every == 0:
                    with span("loop.nan_guard"):
                        # its host sync is the flush's copy, counted there
                        logger.flush()
                        window = logger.history[nan_checked:]
                        nan_checked = len(logger.history)
                        bad = sorted({k for m in window for k, v in m.items()
                                      if v != v or abs(v) == float("inf")})
                    if bad:
                        raise TrainingDiverged(
                            f"non-finite metrics {bad} within the last flush window "
                            f"(ending epoch {epoch} batch {i}, step {global_step}); "
                            f"last checkpoint: {ckpt.latest_step() if ckpt else None}")

                if sample_imgs is not None:
                    with span("loop.grid"):
                        sample_imgs = _gather_rows(replica, sample_imgs)
                        if lead:
                            from vaegan_tpu_torch.utils.imaging import save_image_grid
                            count("host_sync", where="grid")
                            save_image_grid(sample_imgs[:25],
                                            str(sample_dir / f"{batches_done}.png"), nrow=5)
                if (ckpt is not None and tcfg.checkpoint_every > 0
                        and (global_step + 1) % tcfg.checkpoint_every == 0):
                    with span("loop.checkpoint"):
                        ckpt.save(state, replica=replica)
                        dist.barrier(replica.mesh_group)
                global_step += 1
                i += 1
                if tcfg.max_steps is not None and global_step >= tcfg.max_steps:
                    budget_hit = True
                    break

    logger.flush()
    if ckpt is not None:
        # no force: a step the periodic save already wrote is kept
        with span("loop.checkpoint"):
            ckpt.save(state, replica=replica)
            ckpt.wait()
            dist.barrier(replica.mesh_group)
    elapsed = time.time() - t0
    executed = global_step - start_step
    logger.history.append({
        "_wall_s": elapsed,
        "_steps": executed,
        "_steps_per_sec": executed / max(elapsed, 1e-9),
        "_images_per_sec": executed * cfg.data.batch_size / max(elapsed, 1e-9),
    })
    return state, logger
