"""Large-batch WGAN-GP recipe probe, BASELINE config 5 / preset
``vaegan_256_dp`` (the port of ``tools/large_batch_recipe.py``).

The reference's adversarial recipe is tuned for batch 4 at lr 3e-4; at batch
128 the game destabilises late. This tool probes the mitigations (TTUR lr
split, ``n_critics``, lr scaling, EMA, lazy GP, accumulation) cheaply:

- the whole synthetic dataset is staged on the device once and each batch
  gathered there from host-shuffled index arrays (the JAX script's numpy
  draws), so a probe costs step time only;
- every ``--log-every`` steps it records the critic's real and fake scores,
  the penalty and the train reconstruction loss;
- at the end it evaluates eval-mode reconstruction MSE on 3 fresh batches
  (the reference's one-batch metric), for the EMA iterate too when there is
  one.

    python -m vaegan_tpu_torch.tools.large_batch_recipe --steps 3000 --batch 128 \\
        --lr-g 1e-4 --lr-d 3e-4 --n-critics 1 --dtype bfloat16

Prints one JSON line per log and one for the probe, under the JAX script's
keys. The flags are the JAX script's, with its defaults, plus ``--device`` and
``--use-pallas``. Each step is ``make_train_step`` of the schedule's variant
(G+D every ``n_critics``-th batch of an epoch, the penalty every
``--gp-every``-th step with lambda scaled by it); step seeds follow the
port's ``step_seed``.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from vaegan_tpu_torch import inference
from vaegan_tpu_torch.config import Config, preset
from vaegan_tpu_torch.data.pipeline import SyntheticDataset
from vaegan_tpu_torch.tools.common import (
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
from vaegan_tpu_torch.train.state import resolve_device
from vaegan_tpu_torch.train.step import step_seed


def build_parser() -> argparse.ArgumentParser:
    ap = parser(__doc__)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--image-size", type=int, default=96)
    ap.add_argument("--dataset", type=int, default=1200)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--lr-g", type=float, default=None)
    ap.add_argument("--lr-d", type=float, default=None)
    ap.add_argument("--n-critics", type=int, default=1)
    ap.add_argument("--clip", type=float, default=0.01)
    ap.add_argument("--lambda-gp", type=float, default=10.0)
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="microbatch accumulation (e.g. 4 at 256^2 batch 64)")
    ap.add_argument("--ema-decay", type=float, default=None,
                    help="track a generator EMA and also report its eval MSE")
    ap.add_argument("--gp-every", type=int, default=1,
                    help="lazy GP cadence (lambda_gp scaled by k on GP steps)")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save-visuals", default=None, metavar="DIR",
                    help="write orig-vs-recon / prior-sample / interpolation "
                         "PNGs for the best-evaluating iterate (live vs EMA) "
                         "to DIR (inference.save_visual_evidence)")
    add_use_pallas(ap)
    add_device(ap)
    return show_defaults(ap)


def build_config(args) -> Config:
    cfg = preset("notebook")
    return cfg.replace(
        data=cfg.data.replace(image_size=args.image_size, batch_size=args.batch),
        loss=cfg.loss.replace(clip_value=args.clip or None, lambda_gp=args.lambda_gp),
        optim=cfg.optim.replace(lr=args.lr, lr_g=args.lr_g, lr_d=args.lr_d),
        train=cfg.train.replace(dtype=args.dtype, n_critics=args.n_critics,
                                seed=args.seed, grad_accum=args.grad_accum,
                                ema_decay=args.ema_decay, gp_every=args.gp_every,
                                **train_overrides(args)),
    )


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    cfg = build_config(args)
    dev = resolve_device(args.device)
    ds = SyntheticDataset(args.dataset, args.image_size, seed=0)
    data = stage(ds, args.dataset, dev)
    state = create_train_state(cfg, device=dev, seed=args.seed)
    nc = args.n_critics

    def variant(do_g, do_gp=True):
        return make_train_step(cfg, do_g_update=do_g, do_gp=do_gp,
                               gp_lambda_scale=float(args.gp_every))

    steps = {(True, True): variant(True), (False, True): variant(False)}
    if args.gp_every > 1:
        steps.update({(True, False): variant(True, False), (False, False): variant(False, False)})

    rng = np.random.default_rng(args.seed)
    n_batches = args.dataset // args.batch

    def index_stream():
        while True:
            order = rng.permutation(args.dataset)
            for i in range(n_batches):
                yield order[i * args.batch:(i + 1) * args.batch]
    stream = index_stream()

    history = []
    t0 = time.time()
    for sno in range(args.steps):
        idx = np.asarray(next(stream), np.int32)
        do_g = (sno % (args.dataset // args.batch) % nc == 0)
        do_gp = args.gp_every == 1 or sno % args.gp_every == 0
        state, metrics = steps[(do_g, do_gp)](state, gather(data, idx),
                                              step_seed(args.seed, sno))
        if (sno + 1) % args.log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": sno + 1,
                            "recon": m["recon_loss"],
                            "d_real": -m["d_real_loss"],
                            "d_fake": m["d_fake_loss"],
                            "gp": m["gp"]})
            print(json.dumps(history[-1]), flush=True)
            if not all(math.isfinite(v) for v in history[-1].values()):
                print(json.dumps({"verdict": "diverged", "at": sno + 1}), flush=True)
                break
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.time() - t0

    # eval: the reference's one-batch MSE, 3 fresh draws, eval-mode generator
    ema_gen = None if state.g_ema is None else inference.with_ema(state).generator
    draws, ema_draws = [], []
    for _ in range(3):
        b = gather(data, rng.permutation(args.dataset)[: args.batch])
        draws.append(eval_mse(cfg, state.generator, b))
        if ema_gen is not None:
            ema_draws.append(eval_mse(cfg, ema_gen, b))

    visuals = None
    if args.save_visuals:
        vis_state, tag = state, "live"
        if ema_draws and min(ema_draws) < min(draws):
            vis_state, tag = state.replace(generator=ema_gen), "ema"
        b = gather(data, rng.permutation(args.dataset)[: args.batch])
        visuals = inference.save_visual_evidence(
            cfg, vis_state, b, args.save_visuals,
            generator=torch.Generator(device=dev).manual_seed(7),
            prefix=f"b{args.batch}_{args.image_size}px_{tag}_")
        visuals["iterate"] = tag

    scores = [abs(h["d_real"]) for h in history] + [abs(h["d_fake"]) for h in history]
    tail = history[-5:]
    record = {
        "probe": {"batch": args.batch, "image": args.image_size,
                  "lr": args.lr, "lr_g": args.lr_g, "lr_d": args.lr_d,
                  "n_critics": args.n_critics, "clip": args.clip,
                  "lambda_gp": args.lambda_gp, "dtype": args.dtype,
                  "steps": args.steps, "seed": args.seed,
                  "grad_accum": args.grad_accum, "ema_decay": args.ema_decay,
                  "gp_every": args.gp_every},
        "eval_mse_draws": [round(x, 4) for x in draws],
        **({"ema_eval_mse_draws": [round(x, 4) for x in ema_draws]}
           if ema_draws else {}),
        "max_abs_critic_score": round(max(scores), 2) if scores else None,
        "tail_recon": [round(h["recon"], 4) for h in tail],
        "wall_s": round(wall, 1),
        **({"visuals": visuals} if visuals else {}),
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
