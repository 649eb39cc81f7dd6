"""Config-3 (Larsen Algorithm-1) convergence probes (the port of
``tools/paper_probe.py``).

With the notebook's 140M-parameter SN critic the BCE game of ``vaegan_paper``
saturates early (bce_real and bce_fake -> 0, so both the decoder's
adversarial gradient and the critic's feature-shaping pressure vanish). This
tool probes the knobs the config offers, the Dis_l tap (``--feature-tap``),
the decoder's feature-matching weight (``--gamma``) and the TTUR split
(``--lr-d``), cheaply: the dataset (synthetic, or ``--data-dir``'s NIfTI
files) is staged on the device once and each batch is gathered there with
``index_select`` from the JAX script's numpy index draws, so a probe costs
step time only. Every ``--eval-every`` steps it prints the diagnostics the
loop's metric line does not show: eval-mode MSE on a held batch, mean |logit|
of the critic on real and reconstructed images, and the step's Dis_l, L_GAN,
BCE terms and KL.

``--keep-best`` is config 3's recipe: the oscillating game's endpoint
diverges, so the best iterate on the held batch (the EMA when
``--ema-decay`` is set, else the live parameters, with the BN buffers) is
copied on the device whenever it improves, and the final 3-draw eval is
reported for it too.

    python -m vaegan_tpu_torch.tools.paper_probe --data-dir nii_blobs --image-size 256 \\
        --batch 4 --steps 2700 --ema-decay 0.999 --keep-best --use-pallas all

Prints one JSON line per eval and one for the probe, under the JAX script's
keys; eval = the reference's one-batch MSE over 3 repeat draws beside the
mean-predictor floor. The flags are the JAX script's, with its defaults (so
without ``--ema-decay`` the preset's EMA is cleared, as there), plus
``--device`` and ``--use-pallas``. Device draws (step seeds, dropout, noise)
follow the port's streams; the host draws (dataset, indices) are the JAX
script's.
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
from vaegan_tpu_torch.data.pipeline import SyntheticDataset, make_dataset
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
from vaegan_tpu_torch.train import TrainState, create_train_state, make_paper_train_step
from vaegan_tpu_torch.train.state import resolve_device
from vaegan_tpu_torch.train.step import step_seed


def build_parser() -> argparse.ArgumentParser:
    ap = parser(__doc__)
    ap.add_argument("--steps", type=int, default=900)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--image-size", type=int, default=96)
    ap.add_argument("--dataset", type=int, default=1200)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--style", default="blobs",
                    choices=["blobs", "edges", "texture"])
    ap.add_argument("--data-dir", default=None,
                    help="on-disk NIfTI dir (tools.make_nifti_dataset): stage the "
                         "decoded dataset on the device and run the probe on it "
                         "instead of the in-process synthetic stand-in")
    ap.add_argument("--keep-best", action="store_true",
                    help="copy the best held-batch iterate (EMA when --ema-decay "
                         "is set, else live) on the device and report the 3-draw "
                         "eval from THAT iterate too: the oscillating game's recipe")
    ap.add_argument("--save-visuals", default=None, metavar="DIR",
                    help="render the reference's qualitative deliverables "
                         "from the best iterate (requires --keep-best)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--feature-tap", default=None,
                    choices=["res_out", "pool", "fc1"])
    ap.add_argument("--gamma", type=float, default=None)
    ap.add_argument("--lr-d", type=float, default=None,
                    help="TTUR split: critic lr (generator keeps optim.lr)")
    ap.add_argument("--kl-weight", type=float, default=None)
    ap.add_argument("--recon-weight", type=float, default=None)
    ap.add_argument("--eval-every", type=int, default=100)
    ap.add_argument("--ema-decay", type=float, default=None,
                    help="track a generator EMA and also evaluate its iterate "
                         "(the oscillating game reaches the pixel configs' band "
                         "transiently, then oscillates)")
    ap.add_argument("--out", default=None, help="append the JSON line here")
    add_use_pallas(ap)
    add_device(ap)
    return show_defaults(ap)


def build_config(args) -> Config:
    cfg = preset("vaegan_paper")
    cfg = cfg.replace(
        data=cfg.data.replace(image_size=args.image_size, batch_size=args.batch),
        train=cfg.train.replace(dtype=args.dtype, seed=args.seed, ema_decay=args.ema_decay,
                                **train_overrides(args)),
    )
    if args.feature_tap:
        cfg = cfg.replace(discriminator=cfg.discriminator.replace(
            feature_tap=args.feature_tap))
    opt = cfg.optim
    if args.gamma is not None:
        opt = opt.replace(gamma=args.gamma)
    if args.lr_d is not None:
        opt = opt.replace(lr_d=args.lr_d)
    loss = cfg.loss
    if args.kl_weight is not None:
        loss = loss.replace(kl_weight=args.kl_weight)
    if args.recon_weight is not None:
        loss = loss.replace(reconstruction_weight=args.recon_weight)
    cfg = cfg.replace(optim=opt, loss=loss)
    if args.data_dir:
        cfg = cfg.replace(data=cfg.data.replace(root_dir=args.data_dir, synthetic=False,
                                                cache=True))
    return cfg


@torch.inference_mode()
def diagnostics(cfg: Config, state: TrainState, batch: torch.Tensor):
    """Eval-mode pixel MSE of the live generator and the critic's saturation
    probes: mean |logit| on the real batch and on its reconstruction."""
    recon, mse = inference.reconstruction(cfg, state.generator, batch)
    logit_real = state.critic(batch, train=False)
    logit_fake = state.critic(recon.to(batch.dtype), train=False)
    return float(mse), float(logit_real.abs().mean()), float(logit_fake.abs().mean())


def probe_row(cfg: Config, state: TrainState, held: torch.Tensor, metrics, sno: int,
              wall_s: float, ema: bool) -> dict:
    """One curve point under the JAX script's keys."""
    mse, alr, alf = diagnostics(cfg, state, held)
    row = {"step": sno}
    if ema:
        row["eval_mse_ema"] = round(eval_mse(cfg, inference.with_ema(state).generator, held), 4)
    row.update({
        "eval_mse_held": round(mse, 4),
        "dis_l": round(float(metrics["recon_loss"]), 4),
        "l_gan": round(float(metrics["adv_loss"]), 4),
        "bce_real": round(float(metrics["d_real_loss"]), 4),
        "bce_fake": round(float(metrics["d_fake_loss"]), 4),
        "kl_per_sample": round(float(metrics["kl"]), 1),
        "abs_logit_real": round(alr, 2),
        "abs_logit_fake": round(alf, 2),
        "wall_s": round(wall_s, 1)})
    return row


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    cfg = build_config(args)
    dev = resolve_device(args.device)
    if args.data_dir:
        ds = make_dataset(cfg.data)
        args.dataset = len(ds)
    else:
        ds = SyntheticDataset(args.dataset, args.image_size, seed=0, style=args.style)
    data = stage(ds, args.dataset, dev)
    rng = np.random.default_rng(args.seed)

    state = create_train_state(cfg, device=dev, seed=args.seed)
    step = make_paper_train_step(cfg)
    held = gather(data, rng.permutation(args.dataset)[: max(args.batch, 4)])
    floor = inference.mean_predictor_floor(held)
    curve = []
    best = KeepBest() if args.keep_best else None
    t0 = time.time()
    for s in range(args.steps):
        idx = rng.integers(0, args.dataset, size=args.batch)
        state, metrics = step(state, gather(data, idx), step_seed(args.seed + 1, s))
        sno = s + 1
        if sno % args.eval_every == 0 or sno == 1:
            row = probe_row(cfg, state, held, metrics, sno, time.time() - t0,
                            bool(args.ema_decay))
            curve.append(row)
            print(json.dumps(row), flush=True)
            if best is not None:
                best.offer(row.get("eval_mse_ema", row["eval_mse_held"]), sno,
                           state.generator, state.g_ema if args.ema_decay else None)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0

    # cell 23's protocol: 3 fresh one-batch eval MSEs
    best_gen = None if best is None or best.step is None else best.generator(state.generator)
    ema_gen = inference.with_ema(state).generator if args.ema_decay else None
    draws, ema_draws, best_draws = [], [], []
    for _ in range(3):
        b = gather(data, rng.permutation(args.dataset)[: args.batch])
        draws.append(round(diagnostics(cfg, state, b)[0], 4))
        if ema_gen is not None:
            ema_draws.append(round(eval_mse(cfg, ema_gen, b), 4))
        if best_gen is not None:
            best_draws.append(round(eval_mse(cfg, best_gen, b), 4))

    out = {
        "probe": {"feature_tap": cfg.discriminator.feature_tap,
                  "gamma": cfg.optim.gamma, "lr_d": cfg.optim.lr_d,
                  "kl_weight": cfg.loss.kl_weight,
                  "recon_weight": cfg.loss.reconstruction_weight},
        "operating_point": f"{args.image_size}^2 batch {args.batch} "
                           f"{args.dtype}, {args.steps} steps, style={args.style}, "
                           f"seed {args.seed}",
        "eval_mse_repeat_draws": draws,
        **({"eval_mse_repeat_draws_ema": ema_draws,
            "ema_decay": args.ema_decay} if args.ema_decay else {}),
        **({"eval_mse_repeat_draws_best_iterate": best_draws,
            "best_iterate_step": best.step,
            "best_iterate_held_mse": round(best.score, 4)}
           if best_gen is not None else {}),
        "eval_mse_mean_predictor_floor": round(float(floor), 4),
        "curve_min": min((r["eval_mse_held"], r["step"]) for r in curve),
        **({"curve_min_ema": min((r["eval_mse_ema"], r["step"]) for r in curve)}
           if args.ema_decay else {}),
        "final": curve[-1],
        "first": curve[0],
        "images_per_sec": round(args.steps * args.batch / wall, 1),
        "wall_s": round(wall, 1),
    }
    if args.save_visuals and best_gen is not None:
        b = gather(data, rng.permutation(args.dataset)[: max(args.batch, 4)])
        out["visuals"] = inference.save_visual_evidence(
            cfg, state.replace(generator=best_gen), b, args.save_visuals,
            generator=torch.Generator(device=dev).manual_seed(7),
            prefix=f"paper_best_s{args.seed}_")
        out["visuals_iterate"] = f"best@{best.step}"

    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return out


if __name__ == "__main__":
    main()
