"""Data-parallel training over processes, one a device: BASELINE config 5's user
journey (the port of ``examples/train_multichip.py``), over
``parallel.train.train_data_parallel``.

On a host with N cards, one process a card under ``torchrun`` (NCCL):

    torchrun --nproc_per_node=N -m vaegan_tpu_torch.examples.train_multichip
    torchrun --nproc_per_node=N -m vaegan_tpu_torch.examples.train_multichip --model-axis 2

Without ``torchrun``, ``--virtual N`` starts N processes on ``--device`` that
share it through gloo, so the same code runs on one card or on the CPU:

    python -m vaegan_tpu_torch.examples.train_multichip --virtual 2 --device cpu

Several hosts: run the same command on every host with ``--coordinator
host0:1234 --num-processes P --process-id <i>`` (a ``tcp://`` rendezvous; each
process feeds its own rows of every global batch). A process started alone,
with none of these, trains in a world of one. ``--model-axis`` is
``parallel.num_model`` (tensor parallelism of the critic head). Process 0
prints ``trained S steps over D devices (P process(es)) — R img/s``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from pathlib import Path

from vaegan_tpu_torch.config import Config, preset


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--virtual", type=int, default=0,
                    help="start N processes on --device that share it through gloo")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="mesh model-axis size (tensor-parallel critic head)")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--max-steps", type=int, default=0,
                    help="hard optimizer-step budget (0 = unbounded)")
    ap.add_argument("--image-size", type=int, default=96)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of process 0 for multi-host runs")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the CPU)")
    return ap


def build_config(args) -> Config:
    cfg = preset("notebook")
    return cfg.replace(
        data=cfg.data.replace(
            image_size=args.image_size, batch_size=args.batch_size,
            root_dir=args.data_dir or "nii", synthetic=args.data_dir is None),
        train=cfg.train.replace(n_epochs=args.epochs, dtype="bfloat16",
                                max_steps=args.max_steps or None),
        parallel=cfg.parallel.replace(num_model=args.model_axis),
    )


def _train(cfg: Config, device) -> None:
    """Train in the current process group, then end it; process 0 prints the
    closing line."""
    from vaegan_tpu_torch.parallel import dist
    from vaegan_tpu_torch.parallel.train import train_data_parallel

    try:
        state, logger = train_data_parallel(cfg, device=device)
        tail = [m for m in logger.history if "_wall_s" in m]
        rate = tail[-1]["_images_per_sec"] if tail else float("nan")
        n = dist.world_size()
        if dist.rank() == 0:
            print(f"trained {state.step} steps over {n} devices ({n} process(es)) — "
                  f"{rate:.1f} img/s", flush=True)
    finally:
        dist.shutdown()


def _virtual_child(rank: int, n: int, store: str, cfg_path: str, device: str) -> None:
    """Process ``rank`` of a ``--virtual`` run: a gloo world of ``n`` processes
    on ``device``, training the config the parent wrote."""
    import torch

    from vaegan_tpu_torch.parallel import dist

    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    dev = dist.initialize(backend="gloo", init_method=f"file://{store}", world_size=n,
                          rank=rank, device=device)
    _train(Config.from_json(cfg_path), dev)


def _virtual(cfg: Config, n: int, device: str, timeout_s: float = 3600.0) -> None:
    """Start ``n`` processes on ``device`` (a CUDA device without an index is
    this process's current one), wait for them, pass on their output."""
    import torch

    from vaegan_tpu_torch.parallel import dist

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass --device cpu to run on the CPU")
        dev = torch.device("cuda", torch.cuda.current_device() if dev.index is None
                           else dev.index)
    with tempfile.TemporaryDirectory(prefix="vaegan_virtual_") as tmp:
        cfg_path = os.path.join(tmp, "cfg.json")
        Path(cfg_path).write_text(json.dumps(cfg.to_dict()))
        code = ("import sys\nfrom vaegan_tpu_torch.examples.train_multichip import "
                "_virtual_child\n_virtual_child(int(sys.argv[1]), int(sys.argv[2]), "
                "sys.argv[3], sys.argv[4], sys.argv[5])\n")
        res = dist.run_processes(
            [[sys.executable, "-c", code, str(r), str(n), os.path.join(tmp, "store"), cfg_path,
              str(dev)] for r in range(n)], timeout_s)
    sys.stdout.write(res[0][1])
    sys.stdout.flush()
    failed = [r for r, (rc, _, _) in enumerate(res) if rc != 0]
    if failed:
        sys.stderr.write("".join(res[r][2][-4000:] for r in failed))
        raise SystemExit(f"train_multichip --virtual {n}: processes {failed} failed")


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    cfg = build_config(args)
    if args.virtual:
        _virtual(cfg, args.virtual, args.device)
        return
    from vaegan_tpu_torch.parallel import dist

    if args.coordinator:
        dev = dist.initialize(init_method=f"tcp://{args.coordinator}",
                              world_size=args.num_processes, rank=args.process_id,
                              device=args.device)
    else:   # the torchrun environment, or a world of one
        dev = dist.initialize(device=args.device)
    _train(cfg, dev)


if __name__ == "__main__":
    main()
