"""The port's throughput benchmark, ``bench.py``'s modes and one-line JSON
contract on a PyTorch device:

    python -m vaegan_tpu_torch.bench [--paper | --vae | --loop | --infer | --loader]
                                     [--roofline] [--device cuda|cpu]

Each mode prints one JSON line ``{"metric", "value", "unit", "vs_baseline"}``
(``--infer`` prints three, the batch-1 latency last), ``vs_baseline`` = value /
5000 (BASELINE.json's 5k images/s target) from the rounded printed value. The
metric string names the device as ``torch.cuda.get_device_name`` gives it.

Modes:

- default: the notebook WGAN-GP train step (``--vae``: the plain-VAE ablation,
  ``--paper``: the Larsen three-optimizer step), on a synthetic batch resident
  on the device, steps scheduled as ``train()`` schedules them (``n_critics``,
  lazy GP); every step variant of the schedule runs once before the clock
  starts, then whole schedule cycles are timed;
- ``--loop``: one ``train()`` run (``hbm_cache`` feed, metric flushes, no
  grids or checkpoints); the rate is the images of the steps after a
  warm-up in which every step variant runs once, over the time from the start
  of the first timed step to the end of the last, all inside that one run;
- ``--infer``: eval-mode reconstruct images/s, prior-sample images/s, batch-1
  reconstruct latency;
- ``--loader``: the host pipeline's rate (cached synthetic dataset ->
  ``DataLoader``) and with the copy to the device (``device_prefetch``);
- ``--roofline`` (alone, or with ``--paper`` / ``--vae`` for those steps):
  the device's achieved memory rate, measured with a triad (y <- 1.0001 y + b
  over two 1 GiB float32 arrays, one kernel a repetition), the step's time,
  and its flops and bytes from one more step counted after the timed ones
  (``utils.cost_analysis.step_cost``, the counterpart of the XLA cost
  analysis the JAX bench reads), printed as the bytes' implied rate and its
  share of the achieved one, in the JAX bench's keys. ``BENCH_GP_EVERY`` > 1
  attributes the off-step without the penalty, ``BENCH_CRITIC_ONLY=1`` the
  critic-only step. Beside them: the kernels' share of the count
  (``kernels``), and ``fused.LAUNCHES`` over the timed steps (``launches``,
  ``timed_steps``) and over the counted one (``counted_step_launches``; on
  a CPU tensor no kernel launches).

Times on a CUDA device come from CUDA events recorded in stream order around
the timed steps (the span includes any gap where the device waits for the
host); on the CPU from the host clock.

Env knobs, as ``bench.py``'s: BENCH_BATCH (default 128), BENCH_DTYPE
(bfloat16 | float32, default bfloat16), BENCH_STEPS (default 20; 80 for
``--loop``), BENCH_IMAGE (default 96), BENCH_GP_EVERY (notebook default 8,
otherwise 1), BENCH_N_CRITICS (notebook default 5, otherwise 1),
BENCH_DATASET (``--loader``, default 1200), BENCH_CRITIC_BATCHING (default
separate), BENCH_PALLAS (default: the preset's ``use_pallas``),
BENCH_LOG_EVERY (``--loop``, default 1); BENCH_CRITIC_ONLY (``--roofline``,
default 0). ``--roofline`` reads BENCH_GP_EVERY with a default of 1.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time

import torch

LABELS = {"notebook": "VAE-GAN", "vaegan_paper": "Larsen-paper", "notebook_vae": "plain-VAE"}
# the roofline's triad: float32 elements per array (1 GiB) and repetitions
TRIAD_ELEMENTS = 256 * 2 ** 20
TRIAD_REPS = 50


def _env(name: str, default):
    return type(default)(os.environ.get(name, default))


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


class Clock:
    """Marks in stream order on a CUDA device (events), host time elsewhere."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def seconds(self, start, end) -> float:
        if self.cuda:
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        return end - start


def _line(metric: str, value: float, unit: str, baseline: bool = True, **extra) -> None:
    v = round(value, 1) if baseline else round(value, 3)
    print(json.dumps({"metric": metric, "value": v, "unit": unit,
                      "vs_baseline": round(v / 5000.0, 3) if baseline else None, **extra}),
          flush=True)


def _train_cfg(preset_name: str):
    from vaegan_tpu_torch.config import preset

    cfg = preset(preset_name)
    notebook = preset_name == "notebook"
    return cfg.replace(
        data=cfg.data.replace(image_size=_env("BENCH_IMAGE", 96),
                              batch_size=_env("BENCH_BATCH", 128)),
        train=cfg.train.replace(
            dtype=_env("BENCH_DTYPE", "bfloat16"),
            gp_every=_env("BENCH_GP_EVERY", 8 if notebook else 1),
            n_critics=_env("BENCH_N_CRITICS", 5 if notebook else 1),
            critic_batching=_env("BENCH_CRITIC_BATCHING", "separate"),
            use_pallas=_env("BENCH_PALLAS", str(cfg.train.use_pallas))))


def _key(cfg, i: int, gs: int):
    """The ``(do_g_update, do_gp)`` variant ``train()`` runs at batch ``i`` of an
    epoch, global step ``gs``."""
    from vaegan_tpu_torch.train.step import lazy_gp_enabled

    t = cfg.train
    if cfg.optim.scheme == "three":
        return True, True
    return (i % t.n_critics) == 0, (not lazy_gp_enabled(cfg)) or (gs % t.gp_every == 0)


def _cycle(cfg) -> int:
    """Steps in one cycle of the schedule."""
    from vaegan_tpu_torch.train.step import lazy_gp_enabled

    t = cfg.train
    if cfg.optim.scheme == "three":
        return 1
    return math.lcm(t.n_critics, t.gp_every if lazy_gp_enabled(cfg) else 1)


def _warm_up(cfg, per_epoch: int) -> int:
    """The fewest leading steps of ``train()``'s schedule (``per_epoch`` batches
    an epoch) in which every variant of one cycle runs."""
    want = {_key(cfg, i, i) for i in range(_cycle(cfg))}
    seen = set()
    for gs in range(10 ** 6):
        seen.add(_key(cfg, gs % per_epoch, gs))
        if seen == want:
            return gs + 1
    raise AssertionError("unreachable")


def _variants(cfg, wrap=lambda step: step) -> dict:
    from vaegan_tpu_torch.train import make_paper_train_step, make_step_variants, make_train_step

    if cfg.optim.scheme == "three":
        return {(True, True): wrap(make_paper_train_step(cfg))}
    return make_step_variants(cfg, lambda do_g, do_gp, scale: wrap(make_train_step(
        cfg, do_g, do_gp=do_gp, gp_lambda_scale=scale)))


def _sched_label(cfg) -> str:
    from vaegan_tpu_torch.train.step import lazy_gp_enabled

    t = cfg.train
    out = f", lazy GP 1/{t.gp_every}" if lazy_gp_enabled(cfg) else ""
    if t.n_critics > 1 and cfg.optim.scheme != "three":
        out += f", G every {t.n_critics} (n_critics)"
    if t.critic_batching != "separate":
        out += f", critic_batching {t.critic_batching}"
    return out + f", use_pallas {t.use_pallas}"


def bench_step(preset_name: str, dev: torch.device) -> None:
    from vaegan_tpu_torch.train import create_train_state

    cfg = _train_cfg(preset_name)
    b, image, cycle = cfg.data.batch_size, cfg.data.image_size, _cycle(cfg)
    state = create_train_state(cfg, device=dev, seed=0)
    steps = _variants(cfg)
    batch = torch.rand((b, image, image, 1), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(1))
    for i in range(_warm_up(cfg, cycle)):   # every variant once, off the clock
        state, _ = steps[_key(cfg, i, i)](state, batch, i)
    n_steps = _env("BENCH_STEPS", 20)
    n_steps = max(cycle, n_steps - n_steps % cycle)     # whole cycles
    clock = Clock(dev)
    start = clock.mark()
    for i in range(n_steps):
        state, _ = steps[_key(cfg, i, i)](state, batch, 100 + i)
    seconds = clock.seconds(start, clock.mark())
    _line(f"{image}x{image} {LABELS.get(preset_name, preset_name)} train-step "
          f"images/sec/{device_name(dev)} (batch {b}, {cfg.train.dtype}{_sched_label(cfg)}, "
          f"{n_steps} steps)", b * n_steps / seconds, "images/sec/chip")


def bench_loop(dev: torch.device) -> None:
    from vaegan_tpu_torch.train.loop import train
    from vaegan_tpu_torch.utils.metrics import MetricsLogger

    per_epoch = 10
    cfg = _train_cfg("notebook")
    b, image, cycle = cfg.data.batch_size, cfg.data.image_size, _cycle(cfg)
    warm = _warm_up(cfg, per_epoch)
    n_steps = _env("BENCH_STEPS", 80)
    n_steps = max(cycle, n_steps - n_steps % cycle)
    tmp = tempfile.TemporaryDirectory(prefix="vaegan_bench_loop_")
    cfg = cfg.replace(
        data=cfg.data.replace(synthetic=True, synthetic_size=per_epoch * b, drop_last=True,
                              hbm_cache=True),
        train=cfg.train.replace(
            sample_interval=0, checkpoint_dir=None, log_every=_env("BENCH_LOG_EVERY", 1),
            max_steps=warm + n_steps, n_epochs=(warm + n_steps) // per_epoch + 1,
            sample_dir=os.path.join(tmp.name, "samples")))
    clock, marks = Clock(dev), []

    def timed(step):
        def run(state, batch, seed):
            marks.append(clock.mark())      # the start of this step, in stream order
            return step(state, batch, seed)
        return run

    logger = MetricsLogger(sinks=[], flush_every=cfg.train.log_every)
    train(cfg, logger=logger, step_fns=_variants(cfg, timed), device=dev)
    seconds = clock.seconds(marks[warm], clock.mark())
    tmp.cleanup()
    if len(marks) != warm + n_steps:
        raise RuntimeError(f"train() ran {len(marks)} steps, not {warm + n_steps}")
    _line(f"{image}x{image} end-to-end training loop images/sec/{device_name(dev)} (train(): "
          f"hbm_cache feed + logging; batch {b}, {cfg.train.dtype}{_sched_label(cfg)}; "
          f"{n_steps} steps timed inside one run after {warm} warm-up)",
          n_steps * b / seconds, "images/sec/chip", log_every=cfg.train.log_every)


def bench_infer(dev: torch.device) -> None:
    from vaegan_tpu_torch import inference
    from vaegan_tpu_torch.config import preset
    from vaegan_tpu_torch.train import create_generator_state

    b, image = _env("BENCH_BATCH", 128), _env("BENCH_IMAGE", 96)
    dtype, n = _env("BENCH_DTYPE", "bfloat16"), _env("BENCH_STEPS", 20)
    cfg = preset("notebook")
    cfg = cfg.replace(data=cfg.data.replace(image_size=image, batch_size=b),
                      train=cfg.train.replace(dtype=dtype,
                                              use_pallas=_env("BENCH_PALLAS",
                                                              str(cfg.train.use_pallas))))
    state = create_generator_state(cfg, device=dev, seed=0)
    rng = torch.Generator(device=dev).manual_seed(2)
    batch = torch.rand((b, image, image, 1), device=dev, generator=rng)
    clock = Clock(dev)

    def per_call(fn):
        fn()                                # warm
        start = clock.mark()
        for _ in range(n):
            fn()
        return clock.seconds(start, clock.mark()) / n

    t_recon = per_call(lambda: inference.reconstruct(cfg, state, batch))
    t_sample = per_call(lambda: inference.sample(cfg, state, rng, n=b))
    t_one = per_call(lambda: inference.reconstruct(cfg, state, batch[:1]))
    name, tag = device_name(dev), f"(batch {b}, {dtype}, use_pallas {cfg.train.use_pallas})"
    _line(f"{image}x{image} eval-mode reconstruction images/sec/{name} {tag}", b / t_recon,
          "images/sec/chip")
    _line(f"{image}x{image} prior-sample decode images/sec/{name} {tag}", b / t_sample,
          "images/sec/chip")
    _line(f"{image}x{image} batch-1 reconstruction latency on {name}", t_one * 1e3, "ms",
          baseline=False)


def bench_loader(dev: torch.device) -> None:
    from vaegan_tpu_torch.data.pipeline import (
        CachedDataset, DataLoader, SyntheticDataset, device_prefetch)

    b, image, n = _env("BENCH_BATCH", 128), _env("BENCH_IMAGE", 96), _env("BENCH_DATASET", 1200)
    ds = CachedDataset(SyntheticDataset(n, image))
    dl = DataLoader(ds, batch_size=b, shuffle=True, drop_last=True, prefetch_batches=4)
    for _ in iter(dl):                      # decode once, warm the cache
        pass
    t0, imgs = time.perf_counter(), 0
    for _ in range(3):
        for x in iter(dl):
            imgs += x.shape[0]
    host = imgs / (time.perf_counter() - t0)
    for _ in device_prefetch(iter(dl), dev, depth=2):
        pass
    t0, imgs, last = time.perf_counter(), 0, None
    for _ in range(2):
        for x in device_prefetch(iter(dl), dev, depth=2):
            imgs += x.shape[0]
            last = x
    float(last.reshape(-1)[0])              # the last copy has landed
    h2d = imgs / (time.perf_counter() - t0)
    _line(f"{image}x{image} cached-dataset host serving rate (batch {b})", host, "images/sec",
          h2d_images_per_sec=round(h2d, 1), device=device_name(dev))


def triad_rep(y: torch.Tensor, b: torch.Tensor) -> None:
    """One repetition of the triad, y <- 1.0001 y + b in place: one kernel that
    reads two arrays and writes one."""
    torch.add(b, y, alpha=1.0001, out=y)


def triad_gbs(dev: torch.device) -> float:
    """The device's achieved memory rate in GB/s: :func:`triad_rep` over
    :data:`TRIAD_ELEMENTS` float32 elements, :data:`TRIAD_REPS` times."""
    n = TRIAD_ELEMENTS
    y = torch.ones(n, device=dev)
    b = torch.full((n,), 2.0, device=dev)
    triad_rep(y, b)                                 # warm
    clock = Clock(dev)
    start = clock.mark()
    for _ in range(TRIAD_REPS):
        triad_rep(y, b)
    seconds = clock.seconds(start, clock.mark())
    return 3 * 4 * n * TRIAD_REPS / seconds / 1e9


def state_bytes(state) -> int:
    """Bytes of the parameters, their gradients and the optimizer state: what any
    step that updates every parameter reads and writes at least once."""
    total = 0
    for module, opt in ((state.generator, state.opt_g), (state.critic, state.opt_d)):
        for p in module.parameters():
            total += 2 * p.numel() * p.element_size()
            total += sum(v.numel() * v.element_size() for v in opt.state.get(p, {}).values()
                         if isinstance(v, torch.Tensor))
    return total


def bench_roofline(preset_name: str, dev: torch.device) -> None:
    """The JAX bench's roofline attribution of one step variant (module
    docstring), timed on ``dev`` and counted by ``utils.cost_analysis``."""
    from vaegan_tpu_torch.ops import fused
    from vaegan_tpu_torch.train import create_train_state, make_paper_train_step, make_train_step
    from vaegan_tpu_torch.utils.cost_analysis import step_cost

    achieved_gbs = triad_gbs(dev)
    cfg = _train_cfg(preset_name)
    b, image = cfg.data.batch_size, cfg.data.image_size
    no_gp = _env("BENCH_GP_EVERY", 1) > 1
    do_g = os.environ.get("BENCH_CRITIC_ONLY", "0") != "1"
    step = (make_paper_train_step(cfg) if cfg.optim.scheme == "three"
            else make_train_step(cfg, do_g, do_gp=not no_gp))
    state = create_train_state(cfg, device=dev, seed=0)
    batch = torch.rand((b, image, image, 1), device=dev,
                       generator=torch.Generator(device=dev).manual_seed(1))
    for i in range(3):
        state, _ = step(state, batch, i)
    n_steps = _env("BENCH_STEPS", 20)
    clock = Clock(dev)
    fused.reset_launches()
    start = clock.mark()
    for i in range(n_steps):
        state, _ = step(state, batch, 100 + i)
    step_s = clock.seconds(start, clock.mark()) / n_steps
    launches = dict(fused.LAUNCHES)
    # the cost of one more step, after the timed window, as the JAX bench does
    fused.reset_launches()
    cost = step_cost(step, state, batch, 1000)
    counted_launches = dict(fused.LAUNCHES)
    flops, bytes_ = cost["flops"], cost["bytes accessed"]
    implied_gbs = bytes_ / step_s / 1e9
    label = LABELS.get(preset_name, preset_name)
    if not do_g:
        label += " critic-only"
    if no_gp:
        label += " no-GP off-step"
    print(json.dumps({
        "metric": f"roofline attribution, {label} step (achieved-BW-normalized)",
        "achieved_hbm_gbs_triad": round(achieved_gbs, 1),
        "step_cost_flops_T": round(flops / 1e12, 2),
        "step_cost_bytes_GB": round(bytes_ / 1e9, 2),
        "step_ms": round(step_s * 1e3, 1),
        "images_per_sec": round(b / step_s, 1),
        "step_implied_gbs": round(implied_gbs, 1),
        "fraction_of_achieved_bw": round(implied_gbs / achieved_gbs, 3),
        "memory_floor_ms_at_achieved_bw": round(bytes_ / achieved_gbs / 1e6, 1),
        "device": device_name(dev),
        "step_cost_flops": flops, "step_cost_bytes": bytes_,
        "state_bytes": state_bytes(state), "kernels": cost["kernels"],
        "timed_steps": n_steps, "launches": launches, "counted_step_launches": counted_launches,
    }), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m vaegan_tpu_torch.bench")
    mode = p.add_mutually_exclusive_group()
    for m in ("paper", "vae", "loop", "infer", "loader"):
        mode.add_argument(f"--{m}", action="store_true")
    p.add_argument("--roofline", action="store_true",
                   help="roofline attribution of the step (with --paper / --vae: of that step)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = p.parse_args(argv)
    if args.roofline and (args.loop or args.infer or args.loader):
        p.error("--roofline combines with --paper or --vae only")
    from vaegan_tpu_torch.train.state import resolve_device

    dev = resolve_device(args.device)
    preset_name = "vaegan_paper" if args.paper else "notebook_vae" if args.vae else "notebook"
    if args.roofline:
        bench_roofline(preset_name, dev)
    elif args.loader:
        bench_loader(dev)
    elif args.loop:
        bench_loop(dev)
    elif args.infer:
        bench_infer(dev)
    else:
        bench_step(preset_name, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
