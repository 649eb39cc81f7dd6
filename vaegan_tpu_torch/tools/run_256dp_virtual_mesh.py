"""Run BASELINE config 5 (``vaegan_256_dp``) as shipped over ``--devices``
processes (the port of ``tools/run_256dp_virtual_mesh.py``).

The preset's path, ``make_mesh`` -> ``shard_state`` -> the rank-sharded feed ->
the parallel step's variants -> EMA tracking under data parallelism ->
checkpoint and resume -> the EMA iterate's eval, runs end to end at the
preset's operating point (256², global batch 64 split over the processes,
bfloat16, ``ema_decay=0.999``, ``remat`` on by default) on a tiny step
budget. The JAX script makes an N-device virtual CPU mesh in one process;
here N processes share ``--device`` through gloo (a ``file://`` store), the
way ``examples.train_multichip --virtual`` starts them
(``parallel.dist.run_processes``), so the same command runs on the CPU, on
one card, or with one process a card.

- phase A: ``train_data_parallel`` for ``--steps`` steps with
  ``checkpoint_every=1``;
- phase B: a resume from that checkpoint for one more step;
- then process 0 evaluates the live and the EMA iterate (the reference's
  one-batch MSE on one global batch).

    python -m vaegan_tpu_torch.tools.run_256dp_virtual_mesh [--devices 8] [--steps 2]

Process 0 prints one JSON line under the JAX script's keys. The flags are the
JAX script's, with its defaults, plus ``--device`` and ``--use-pallas``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

from vaegan_tpu_torch.config import Config, preset
from vaegan_tpu_torch.tools.common import (
    add_device,
    add_use_pallas,
    parser,
    show_defaults,
    train_overrides,
)

# the seconds the processes may take together
TIMEOUT_S = 7200.0
# process ``rank``: python -c CHILD rank world store cfg_path device steps
CHILD = ("import sys\n"
         "from vaegan_tpu_torch.tools.run_256dp_virtual_mesh import rank_main\n"
         "rank_main(*sys.argv[1:])\n")


def build_parser() -> argparse.ArgumentParser:
    ap = parser(__doc__)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--steps", type=int, default=2,
                    help="phase-A step budget (phase B resumes for one more)")
    ap.add_argument("--remat", action="store_true", default=True,
                    help="train.remat=True (the shipped activation-memory "
                         "lever): N processes on one device each hold a "
                         "256^2 GP step's activations")
    ap.add_argument("--no-remat", dest="remat", action="store_false")
    add_use_pallas(ap)
    add_device(ap)
    return show_defaults(ap)


def build_config(args, tmp: str) -> Config:
    """The preset's operating point (256², global batch 64, bfloat16, EMA
    0.999); only the budget and the data (2 synthetic batches an epoch) are
    cut, and checkpoints and grids go under ``tmp``."""
    cfg = preset("vaegan_256_dp")
    return cfg.replace(
        data=cfg.data.replace(synthetic=True, synthetic_size=128, drop_last=True),
        parallel=cfg.parallel.replace(num_data=args.devices),
        train=cfg.train.replace(
            max_steps=args.steps, n_epochs=10, log_every=1, remat=args.remat,
            sample_interval=0, checkpoint_every=1,
            checkpoint_dir=os.path.join(tmp, "ckpt"),
            sample_dir=os.path.join(tmp, "samples"), **train_overrides(args)),
    )


def rank_command(rank: int, world: int, store: str, cfg_path: str, device: str,
                 steps: int) -> list:
    """The argv of process ``rank``."""
    return [sys.executable, "-c", CHILD, str(rank), str(world), store, cfg_path, device,
            str(steps)]


def finite(values) -> bool:
    return all(v == v and abs(v) != float("inf") for v in values)


def rank_main(rank, world, store, cfg_path, device, steps) -> None:
    """Process ``rank`` of ``world``: phases A and B, then (process 0) the
    eval and the JSON line."""
    import torch

    from vaegan_tpu_torch import inference
    from vaegan_tpu_torch.data.pipeline import make_loader
    from vaegan_tpu_torch.parallel import dist
    from vaegan_tpu_torch.parallel.train import train_data_parallel

    rank, world, steps = int(rank), int(world), int(steps)
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    dev = dist.initialize(backend="gloo", init_method=f"file://{store}", world_size=world,
                          rank=rank, device=device)
    try:
        cfg = Config.from_json(cfg_path)
        t0 = time.time()
        state, logger = train_data_parallel(cfg, device=dev)
        phase_a_wall = time.time() - t0
        metrics = [m for m in logger.history if "_wall_s" not in m]
        if len(metrics) != steps or not all(finite(m.values()) for m in metrics):
            raise SystemExit(f"phase A: {len(metrics)} finite steps logged, want {steps}")
        if state.g_ema is None or state.step != steps:
            raise SystemExit("phase A: no EMA, or the state's step is not the budget")

        # phase B: resume from the checkpoint for one more step
        cfg_b = cfg.replace(train=cfg.train.replace(max_steps=steps + 1))
        t0 = time.time()
        state_b, _ = train_data_parallel(cfg_b, resume=True, device=dev)
        phase_b_wall = time.time() - t0
        if state_b.step != steps + 1 or state_b.g_ema is None:
            raise SystemExit("phase B: the resumed run did not take one more step")
    finally:
        dist.shutdown()
    if rank != 0:
        return
    # the preset's eval: the live and the EMA iterate on one global batch
    loader = make_loader(cfg.data, seed=1, process_index=0, process_count=1, device=dev)
    mse_live = inference.evaluate_mse(cfg, state_b, iter(loader))
    mse_ema = inference.evaluate_mse(cfg, inference.with_ema(state_b), iter(loader))
    print(json.dumps({
        "run": f"vaegan_256_dp as shipped over {world} gloo processes on {dev}",
        "mesh": f"data={world}",
        "operating_point": f"{cfg.data.image_size}^2 global batch {cfg.data.batch_size} "
                           f"({world}-way sharded), {cfg.train.dtype}, "
                           f"ema_decay={cfg.train.ema_decay}, "
                           f"remat={cfg.train.remat}",
        "phase_a_steps": steps,
        "phase_a_wall_s": round(phase_a_wall, 1),
        "phase_b_resumed_to_step": state_b.step,
        "phase_b_wall_s": round(phase_b_wall, 1),
        "final_metrics": {k: round(float(v), 4) for k, v in metrics[-1].items()},
        "eval_mse_live": round(mse_live, 4),
        "eval_mse_ema": round(mse_ema, 4),
    }), flush=True)


def main(argv=None) -> None:
    import torch

    from vaegan_tpu_torch.parallel import dist

    args = build_parser().parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
        dev = torch.device("cuda", torch.cuda.current_device() if dev.index is None
                           else dev.index)
    with tempfile.TemporaryDirectory(prefix="vm256dp_") as tmp:
        cfg = build_config(args, tmp)
        cfg_path = os.path.join(tmp, "cfg.json")
        Path(cfg_path).write_text(json.dumps(cfg.to_dict()))
        res = dist.run_processes(
            [rank_command(r, args.devices, os.path.join(tmp, "store"), cfg_path, str(dev),
                          args.steps) for r in range(args.devices)], TIMEOUT_S)
    sys.stdout.write(res[0][1])
    sys.stdout.flush()
    failed = [r for r, (rc, _, _) in enumerate(res) if rc != 0]
    if failed:     # each failed process's last lines, the first to fail among them
        sys.stderr.write("".join(f"-- process {r}:\n{res[r][2][-1500:]}\n" for r in failed))
        raise SystemExit(f"run_256dp_virtual_mesh: processes {failed} failed")


if __name__ == "__main__":
    main()
