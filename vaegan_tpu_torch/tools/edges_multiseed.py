"""Multi-seed paired VAE-GAN against plain-VAE runs (the port of
``tools/edges_multiseed.py``).

At the reference's batch-4 recipe, live eval-mode MSE spreads widely across
otherwise identical runs (BatchNorm running-statistic drift), so a one-seed
ordering of the two arms is no evidence. This tool makes the comparison
seed-robust: N seeds x 2 arms, each arm trained by
``python -m vaegan_tpu_torch.examples.reproduce_headline`` at the same recipe
in a process of its own, each endpoint evaluated live and after BN
recalibration, every number beside the dataset's mean-predictor floor. The
paired comparison on the recalibrated iterate is the primary readout.

    python -m vaegan_tpu_torch.tools.edges_multiseed --seeds 4 --image-size 96 \\
        --style edges --out result/edges_multiseed

Writes ``runs.jsonl`` and ``summary.json`` under ``--out`` and prints the
summary line, under the JAX script's keys. The runs are serialised. The flags
are the JAX script's, with its defaults, plus ``--device`` (passed to every
run) and ``--use-pallas`` (passed on when given).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

from vaegan_tpu_torch.tools.common import add_device, add_use_pallas, parser, show_defaults
from vaegan_tpu_torch.train.state import resolve_device

ROOT = Path(__file__).resolve().parents[2]


def build_parser() -> argparse.ArgumentParser:
    ap = parser(__doc__)
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--image-size", type=int, default=96)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--style", default="edges", choices=["blobs", "edges", "texture"])
    ap.add_argument("--data-dir", default=None,
                    help="on-disk NIfTI dir (e.g. nii_blobs from "
                         "tools.make_nifti_dataset): run both arms through the "
                         "real file-ingest chain instead of the in-process "
                         "synthetic stand-in")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--recalibrate-bn", type=int, default=50)
    ap.add_argument("--save-visuals-seed", type=int, default=0,
                    help="the seed whose endpoints also render the qualitative "
                         "panels (-1: none)")
    ap.add_argument("--per-run-timeout", type=int, default=1800)
    ap.add_argument("--out", default="result/edges_multiseed")
    add_use_pallas(ap)
    add_device(ap)
    return show_defaults(ap)


def arm_command(vae: bool, seed: int, args) -> list:
    """The ``reproduce_headline`` command of one arm and seed."""
    cmd = [
        sys.executable, "-u", "-m", "vaegan_tpu_torch.examples.reproduce_headline",
        "--image-size", str(args.image_size),
        "--batch-size", str(args.batch_size),
        "--epochs", str(args.epochs),
        *(["--data-dir", args.data_dir] if args.data_dir
          else ["--data-style", args.style]),
        "--seed", str(seed),
        "--recalibrate-bn", str(args.recalibrate_bn),
        "--dtype", args.dtype,
        "--out", f"{args.out}/runs/{'vae' if vae else 'vaegan'}_s{seed}",
        "--device", args.device,
    ]
    if args.use_pallas is not None:
        cmd += ["--use-pallas", args.use_pallas]
    if vae:
        cmd.append("--vae")
    if args.save_visuals_seed == seed:
        cmd += ["--save-visuals", f"{args.out}/visuals"]
    return cmd


def run_arm(vae: bool, seed: int, args) -> dict:
    cmd = arm_command(vae, seed, args)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                       timeout=args.per_run_timeout)
    if r.returncode != 0:
        raise RuntimeError(f"{cmd} failed:\n{r.stdout[-2000:]}\n{r.stderr[-2000:]}")
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    rec["seed"] = seed
    return rec


def summarize(runs: list, args) -> dict:
    """The paired per-seed comparison over the runs' records."""
    def best(rec, key):
        return min(rec[key])

    floor = runs[0]["eval_mse_mean_predictor_floor"]
    pairs = []
    for seed in range(args.seeds):
        gan = next(r for r in runs if r["seed"] == seed and r["run"] == "VAE-GAN")
        vae = next(r for r in runs if r["seed"] == seed and r["run"] == "plain-VAE")
        pairs.append({
            "seed": seed,
            "vaegan_live": best(gan, "eval_mse_repeat_draws"),
            "vae_live": best(vae, "eval_mse_repeat_draws"),
            "vaegan_recal": best(gan, "eval_mse_repeat_draws_bn_recalibrated"),
            "vae_recal": best(vae, "eval_mse_repeat_draws_bn_recalibrated"),
        })
    wins_recal = sum(p["vaegan_recal"] < p["vae_recal"] for p in pairs)
    wins_live = sum(p["vaegan_live"] < p["vae_live"] for p in pairs)

    def mean(k):
        return round(sum(p[k] for p in pairs) / len(pairs), 4)

    return {
        "experiment": "paired VAE-GAN vs plain-VAE, multi-seed",
        "operating_point": f"{args.image_size}^2 batch {args.batch_size} x "
                           f"{args.epochs} epochs ({args.dtype}), "
                           f"data={args.data_dir or ('synthetic:' + args.style)}, "
                           f"{args.seeds} seeds",
        "mean_predictor_floor": floor,
        "pairs": pairs,
        "vaegan_wins_recalibrated": f"{wins_recal}/{len(pairs)}",
        "vaegan_wins_live": f"{wins_live}/{len(pairs)}",
        "mean_vaegan_recal": mean("vaegan_recal"),
        "mean_vae_recal": mean("vae_recal"),
        "mean_vaegan_live": mean("vaegan_live"),
        "mean_vae_live": mean("vae_live"),
    }


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)      # fail here, not in the first run
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    runs = []
    runs_path = out / "runs.jsonl"
    for seed in range(args.seeds):
        for vae in (False, True):
            rec = run_arm(vae, seed, args)
            runs.append(rec)
            with open(runs_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
            print(json.dumps({k: rec[k] for k in
                              ("run", "seed", "eval_mse_repeat_draws",
                               "eval_mse_repeat_draws_bn_recalibrated",
                               "eval_mse_mean_predictor_floor")}), flush=True)
    summary = summarize(runs, args)
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
