"""Reproduce the reference's headline experiment at its native operating point
(the port of ``examples/reproduce_headline.py``).

The reference's published numbers come from 256x256 images, batch 4, 3 epochs,
lr 3e-4, with eval = one-batch reconstruction MSE repeated over fresh shuffled
draws (cell 23's protocol; VAE-GAN band 0.0518-0.0573, plain-VAE 0.0790-0.0983
on the hand X-rays).

    python -m vaegan_tpu_torch.examples.reproduce_headline                 # VAE-GAN, synthetic
    python -m vaegan_tpu_torch.examples.reproduce_headline --vae           # plain-VAE ablation
    python -m vaegan_tpu_torch.examples.reproduce_headline --data-dir nii  # the real dataset

Prints one JSON line with the final train metrics and the repeat-draw eval
MSEs, under the JAX script's keys. The flags are the JAX script's, with its
defaults, plus ``--device`` (default ``cuda``). One difference is deliberate:
the JAX script always passes ``ema_decay=args.ema_decay``, so without the flag
it clears a preset's own EMA (``vaegan_paper``'s 0.999); here ``--ema-decay``
overrides the preset only when it is given, and the EMA draws are reported
whenever the run keeps an EMA.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import torch

from vaegan_tpu_torch import inference
from vaegan_tpu_torch.config import Config, preset
from vaegan_tpu_torch.data.pipeline import make_loader
from vaegan_tpu_torch.train.loop import train
from vaegan_tpu_torch.train.state import resolve_device

RUN_NAMES = {"notebook": "VAE-GAN", "notebook_vae": "plain-VAE",
             "vaegan_paper": "VAE-GAN-paper"}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--vae", action="store_true",
                    help="the plain-VAE ablation (adv weight 0, dummy critic)")
    ap.add_argument("--preset", default=None,
                    choices=["notebook", "notebook_vae", "vaegan_paper"],
                    help="config preset; default notebook (or notebook_vae "
                         "with --vae). 'vaegan_paper' = BASELINE config 3: "
                         "Dis_l feature-matching + BCE + three optimizers "
                         "(Larsen et al. Algorithm 1)")
    ap.add_argument("--feature-tap", default=None,
                    choices=["res_out", "pool", "fc1"],
                    help="Dis_l tap override (paper preset only)")
    ap.add_argument("--gamma", type=float, default=None,
                    help="decoder feature-matching weight override (Larsen "
                         "alg. 1; paper preset only)")
    ap.add_argument("--n-critics", type=int, default=None,
                    help="override TrainConfig.n_critics (G every n-th batch)")
    ap.add_argument("--gp-every", type=int, default=None,
                    help="override TrainConfig.gp_every (lazy-GP schedule; "
                         "1 = reference-faithful every-step GP)")
    ap.add_argument("--data-dir", default=None,
                    help="real NIfTI dir; default: the synthetic stand-in sized "
                         "like the reference's dataset (~1200 images)")
    ap.add_argument("--data-style", default="blobs",
                    choices=["blobs", "edges", "texture"],
                    help="synthetic-data style (ignored with --data-dir)")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--max-steps", type=int, default=None,
                    help="cap total train steps (smoke/verify drives)")
    ap.add_argument("--image-size", type=int, default=256)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--draws", type=int, default=3,
                    help="repeat-draw eval count (cell 23 runs it repeatedly)")
    ap.add_argument("--out", default="headline_out")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--ema-decay", type=float, default=None,
                    help="track a generator-param EMA and report BOTH iterates "
                         "at eval (default: the preset's own)")
    ap.add_argument("--recalibrate-bn", type=int, default=0, metavar="N",
                    help="also report eval MSE after re-estimating the BN "
                         "running stats from N data batches "
                         "(inference.recalibrate_bn_stats)")
    ap.add_argument("--use-pallas", default=None, choices=["off", "losses", "all"],
                    help="override TrainConfig.use_pallas (the fused CUDA kernels)")
    ap.add_argument("--seed", type=int, default=None,
                    help="override TrainConfig.seed")
    ap.add_argument("--save-visuals", default=None, metavar="DIR",
                    help="write the reference's qualitative deliverables "
                         "(orig-vs-recon panel, prior-sample grid, latent "
                         "interpolation strips) for the final state to DIR")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the CPU)")
    return ap


def preset_name(args) -> str:
    name = args.preset or ("notebook_vae" if args.vae else "notebook")
    if args.vae and args.preset not in (None, "notebook_vae"):
        raise SystemExit("--vae conflicts with --preset " + args.preset)
    return name


def build_config(args) -> Config:
    """The run's config: the JAX script's, except that ``--ema-decay``
    replaces the preset's EMA only when it is given (module docstring)."""
    cfg = preset(preset_name(args))
    if args.feature_tap is not None:
        cfg = cfg.replace(discriminator=cfg.discriminator.replace(
            feature_tap=args.feature_tap))
    if args.gamma is not None:
        cfg = cfg.replace(optim=cfg.optim.replace(gamma=args.gamma))
    overrides = {"ema_decay": args.ema_decay, "use_pallas": args.use_pallas,
                 "seed": args.seed, "n_critics": args.n_critics,
                 "gp_every": args.gp_every, "max_steps": args.max_steps}
    return cfg.replace(
        data=cfg.data.replace(
            image_size=args.image_size, batch_size=args.batch_size,
            root_dir=args.data_dir or "nii", synthetic=args.data_dir is None,
            synthetic_style=args.data_style, cache=args.data_dir is not None),
        train=cfg.train.replace(
            n_epochs=args.epochs, dtype=args.dtype, sample_interval=100,
            sample_dir=f"{args.out}/samples", log_every=50,
            **{k: v for k, v in overrides.items() if v is not None}),
    )


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    name = preset_name(args)
    cfg = build_config(args)
    dev = resolve_device(args.device)
    Path(args.out).mkdir(parents=True, exist_ok=True)

    t0 = time.time()
    state, logger = train(cfg, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0

    # cell-23 protocol: fresh shuffled one-batch MSE per draw
    loader = make_loader(cfg.data, seed=1, device=dev)
    floor = inference.mean_predictor_floor(next(iter(loader)), device=dev)
    draws = [inference.evaluate_mse(cfg, state, iter(loader)) for _ in range(args.draws)]
    ema_draws = None
    if state.g_ema is not None:
        ema_state = inference.with_ema(state)
        ema_draws = [inference.evaluate_mse(cfg, ema_state, iter(loader))
                     for _ in range(args.draws)]
    recal_draws = None
    if args.recalibrate_bn:
        recal = inference.recalibrate_bn_stats(
            cfg, state, make_loader(cfg.data, seed=2, device=dev),
            num_batches=args.recalibrate_bn)
        recal_draws = [inference.evaluate_mse(cfg, recal, iter(loader))
                       for _ in range(args.draws)]

    tail = [m for m in logger.history if "_wall_s" not in m][-1]
    out = {
        "run": RUN_NAMES[name],
        "preset": name,
        "operating_point": f"{args.image_size}^2 batch {args.batch_size} "
                           f"x {args.epochs} epochs ({args.dtype})",
        "data": args.data_dir or f"synthetic:{args.data_style}",
        "steps": int(state.step),
        "train_wall_s": round(wall, 1),
        "final_train_metrics": {k: round(float(v), 4) for k, v in tail.items()},
        "eval_mse_repeat_draws": [round(m, 4) for m in draws],
        # the strongest trivial baseline on THIS data (per-image variance): an
        # eval MSE is only meaningful relative to it
        "eval_mse_mean_predictor_floor": round(floor, 4),
        "reference_band": (
            "0.0790-0.0983" if args.vae else
            "n/a (comparison anchor: VAE-GAN 0.0518-0.0573)"
            if name == "vaegan_paper" else "0.0518-0.0573"),
    }
    if name == "vaegan_paper":
        out["feature_tap"] = cfg.discriminator.feature_tap
        out["gamma"] = cfg.optim.gamma
    if args.n_critics is not None or args.gp_every is not None:
        out["schedule"] = {"n_critics": cfg.train.n_critics,
                           "gp_every": cfg.train.gp_every}
    if ema_draws is not None:
        out["eval_mse_repeat_draws_ema"] = [round(m, 4) for m in ema_draws]
    if recal_draws is not None:
        out["eval_mse_repeat_draws_bn_recalibrated"] = [round(m, 4) for m in recal_draws]
    if args.save_visuals:
        # render from the best-evaluating iterate reported above: EMA when it
        # wins, BN-recalibrated when requested, else the live params
        vis_state, tag = state, "live"
        if ema_draws is not None and min(ema_draws) < min(draws):
            vis_state, tag = inference.with_ema(state), "ema"
        if recal_draws is not None and min(recal_draws) < min(ema_draws or draws):
            vis_state, tag = recal, "bn_recalibrated"
        batch = next(iter(make_loader(cfg.data, seed=1, device=dev)))
        out["visuals"] = inference.save_visual_evidence(
            cfg, vis_state, batch, args.save_visuals,
            generator=torch.Generator(device=dev).manual_seed(7),
            prefix=f"{out['run']}_{tag}_".replace(" ", ""))
        out["visuals_iterate"] = tag
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
