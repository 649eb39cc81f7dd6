"""BASELINE config 2 (``gan_only``) at a DCGAN-class step budget (the port of
``tools/gan_only_budget.py``).

With no reconstruction anchor the BCE game is critic-dominant at short
budgets while the generator keeps learning under the non-saturating loss.
This tool runs the budget such games train at (10-20k steps) and records:

- the reconstruction-proxy curve: eval-mode one-batch MSE (the reference's
  metric) on a held batch every ``--eval-every`` steps; no loss term of this
  config optimises it, so it measures what the generator absorbs from the
  adversarial pressure alone;
- 5x5 sample grids every ``--grid-every`` steps (train-mode forwards whose BN
  updates are discarded, as the JAX script's are);
- a log-log least-squares fit of the proxy against the steps.

``--keep-best`` is config 2's recipe: the held-batch proxy's best iterate
(parameters and BN buffers) is copied on the device whenever it improves and
delivered beside the live endpoint (``best_recon_panel.png``), since the game
destabilises later.

    python -m vaegan_tpu_torch.tools.gan_only_budget --steps 20000 --batch 64 --keep-best

Writes the grids, ``final_recon_panel.png``, ``curve.jsonl`` and
``summary.json`` to ``--out`` and prints the summary, under the JAX script's
keys. The flags are the JAX script's, with its defaults, plus ``--device`` and
``--use-pallas``. The dataset is staged on the device and batches gathered
there from the JAX script's numpy index draws; device draws follow the port's
streams.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from vaegan_tpu_torch import inference
from vaegan_tpu_torch.config import Config, preset
from vaegan_tpu_torch.data.pipeline import SyntheticDataset
from vaegan_tpu_torch.models.layers import precision
from vaegan_tpu_torch.tools.common import (
    KeepBest,
    add_device,
    add_use_pallas,
    eval_mse,
    gather,
    parser,
    show_defaults,
    stage,
    train_overrides,
)
from vaegan_tpu_torch.train import create_train_state, make_train_step
from vaegan_tpu_torch.train.state import DTYPES, resolve_device
from vaegan_tpu_torch.train.step import kept_buffers, step_seed
from vaegan_tpu_torch.utils.imaging import save_image_grid


def build_parser() -> argparse.ArgumentParser:
    ap = parser(__doc__)
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--image-size", type=int, default=96)
    ap.add_argument("--dataset", type=int, default=1200)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--style", default="blobs",
                    choices=["blobs", "edges", "texture"])
    ap.add_argument("--lr-d", type=float, default=None,
                    help="optional TTUR critic lr (round 3 probed 3e-5)")
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--grid-every", type=int, default=2000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--keep-best", action="store_true",
                    help="the unanchored BCE game's recipe: copy the generator's "
                         "parameters and BN buffers on the device whenever the "
                         "held-batch proxy improves, and deliver the BEST iterate "
                         "beside the live endpoint, so the curve minimum survives "
                         "the game's later divergence")
    ap.add_argument("--out", default="result/gan_only_budget")
    add_use_pallas(ap)
    add_device(ap)
    return show_defaults(ap)


def build_config(args) -> Config:
    cfg = preset("gan_only")
    return cfg.replace(
        data=cfg.data.replace(image_size=args.image_size, batch_size=args.batch),
        optim=cfg.optim.replace(lr_d=args.lr_d),
        train=cfg.train.replace(dtype=args.dtype, seed=args.seed, **train_overrides(args)),
    )


@torch.no_grad()
def sample_grid(cfg: Config, gen, batch: torch.Tensor, seed: int) -> torch.Tensor:
    """The first 25 images of a train-mode forward (dropout and noise drawn
    from ``seed``), on clones of the BN buffers: the state is left as it was."""
    draws = torch.Generator(device=batch.device).manual_seed(seed)
    with kept_buffers(gen), precision(DTYPES[cfg.train.dtype]):
        out = gen(batch, train=True, generator=draws, seeds=torch.Generator().manual_seed(seed))
    return (out[0] if cfg.generator.is_vae else out)[:25]


def recon_panel(cfg: Config, gen, held: torch.Tensor, path: Path) -> None:
    """The first 12 held images and their eval-mode reconstructions, in pairs."""
    recons = inference.eval_reconstruct(cfg, gen, held[:12])[0].float().cpu().numpy()
    orig = held[:12].float().cpu().numpy()
    panel = np.stack([orig, recons], 1).reshape(-1, *orig.shape[1:])
    save_image_grid(panel, str(path), nrow=6)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    cfg = build_config(args)
    dev = resolve_device(args.device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    ds = SyntheticDataset(args.dataset, args.image_size, seed=0, style=args.style)
    data = stage(ds, args.dataset, dev)
    rng = np.random.default_rng(args.seed)
    state = create_train_state(cfg, device=dev, seed=args.seed)
    step = make_train_step(cfg, do_g_update=True)
    gen = state.generator

    held = gather(data, rng.permutation(args.dataset)[: args.batch])
    floor = inference.mean_predictor_floor(held)
    curve = []
    best = KeepBest() if args.keep_best else None
    t0 = time.time()
    for s in range(args.steps):
        idx = rng.integers(0, args.dataset, size=args.batch)
        state, metrics = step(state, gather(data, idx), step_seed(args.seed + 1, s))
        sno = s + 1
        if sno % args.eval_every == 0 or sno == 1:
            row = {"step": sno, "recon_proxy": eval_mse(cfg, gen, held),
                   "d_loss": float(metrics["d_loss"]), "g_loss": float(metrics["g_loss"]),
                   "wall_s": round(time.time() - t0, 1)}
            curve.append(row)
            print(json.dumps(row), flush=True)
            if best is not None:
                best.offer(row["recon_proxy"], sno, gen)
        if sno % args.grid_every == 0 or sno == 1:
            imgs = sample_grid(cfg, gen, held, step_seed(args.seed + 1, s))
            save_image_grid(imgs.float().cpu().numpy(), str(out / f"samples_{sno:06d}.png"),
                            nrow=5)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0

    # the endpoint's eval-mode deliverables (no noise, running-statistics BN)
    recon_panel(cfg, gen, held, out / "final_recon_panel.png")
    if best is not None and best.step is not None:
        recon_panel(cfg, best.generator(gen), held, out / "best_recon_panel.png")

    (out / "curve.jsonl").write_text("\n".join(json.dumps(r) for r in curve) + "\n")
    # log-log fit over the tail (the first 10% left out: the proxy's fast
    # initial drop)
    tail = [r for r in curve if r["step"] >= args.steps // 10]
    xs = np.log([r["step"] for r in tail])
    ys = np.log([max(r["recon_proxy"], 1e-9) for r in tail])
    slope, intercept = np.polyfit(xs, ys, 1)
    # the steps the proxy would need to reach the anchored configs' band
    # (~0.05) if the fitted power law held
    target = 0.05
    steps_to_target = (float(np.exp((np.log(target) - intercept) / slope))
                       if slope < 0 else None)
    summary = {
        "run": "gan_only long budget",
        "operating_point": f"{args.image_size}^2 batch {args.batch} "
                           f"{args.dtype}, {args.steps} steps, style={args.style}"
                           + (f", lr_d={args.lr_d}" if args.lr_d else ""),
        "recon_proxy_first": curve[0]["recon_proxy"],
        "recon_proxy_last": curve[-1]["recon_proxy"],
        "recon_proxy_mean_predictor_floor": round(float(floor), 4),
        "d_loss_last": curve[-1]["d_loss"],
        "g_loss_last": curve[-1]["g_loss"],
        "loglog_fit": {"slope": round(float(slope), 3),
                       "intercept": round(float(intercept), 3),
                       "fit_points": len(tail)},
        "extrapolated_steps_to_0.05_proxy": (round(steps_to_target)
                                             if steps_to_target else None),
        "images_per_sec": round(args.steps * args.batch / wall, 1),
        "wall_s": round(wall, 1),
        "out": str(out),
    }
    if best is not None and best.step is not None:
        summary["keep_best"] = {
            "best_step": best.step, "best_recon_proxy": round(best.score, 4),
            "vs_live_endpoint": curve[-1]["recon_proxy"],
            "panel": "best_recon_panel.png"}
    (out / "summary.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
