"""Byte audit of the Larsen paper step's loss section (the port of
``tools/paper_loss_fusion_evidence.py``).

It isolates the loss math ``make_paper_train_step`` runs downstream of the
network forwards (the same ``losses`` calls and the same weighting into the
three group losses) plus the reparameterisation that makes z, and folds in a
``z_cot`` input standing in for the decoder's cotangent, so that the backward
through z -> (mu, log_var) is part of the audit. Forward and
``torch.autograd.grad`` for the same four inputs (mu, log_var, f_real,
f_tilde) are counted by ``utils.cost_analysis.step_cost`` (every ATen op's own
traffic; with ``--pallas`` z comes from ``fused.reparam_kl``, rows 3 and 4,
counted by their formula through ``fused.counting``) against the fully fused
ideal:

- aggressive: one pass reads mu, log_var, z_cot, f_real and f_tilde once
  (eps made in registers, logits negligible) and writes z, dmu, dlog_var,
  df_real and df_tilde once;
- conservative: plus one re-read of each forward input by a separate
  backward pass.

The formulas are the JAX script's. Beside the bytes: the time of the
section (CUDA events; not measured on the CPU) and each op's bytes.

    python -m vaegan_tpu_torch.tools.paper_loss_fusion_evidence            # notebook scale
    python -m vaegan_tpu_torch.tools.paper_loss_fusion_evidence --pallas   # fused reparam_kl
    python -m vaegan_tpu_torch.tools.paper_loss_fusion_evidence --hlo ops.txt

Prints one JSON document under the JAX script's keys (``measured_bytes_MB``
is the counted bytes) plus ``ms``, ``kernel_calls`` and ``bytes_MB_by_op``.
``--hlo`` writes the op list (there is no HLO to dump). The flags are the JAX
script's, with its defaults, plus ``--device``.
"""

from __future__ import annotations

import argparse
import json
from collections import Counter
from pathlib import Path

import torch

from vaegan_tpu_torch import losses
from vaegan_tpu_torch.config import Config, preset
from vaegan_tpu_torch.inference import latent_shape
from vaegan_tpu_torch.models.layers import precision
from vaegan_tpu_torch.ops import fused
from vaegan_tpu_torch.tools.common import add_device, cuda_ms, parser, show_defaults
from vaegan_tpu_torch.train.state import DTYPES, resolve_device
from vaegan_tpu_torch.utils.cost_analysis import step_cost


def build_parser() -> argparse.ArgumentParser:
    ap = parser(__doc__)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--image-size", type=int, default=96)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--pallas", action="store_true",
                    help="route the reparameterization through the fused "
                         "reparam_kl CUDA kernel (rows 3 and 4: the config's "
                         "use_pallas 'losses') instead of plain torch ops")
    ap.add_argument("--hlo", help="write the op list (each op's name and bytes, in "
                                  "order) here")
    add_device(ap)
    return show_defaults(ap)


def build_config(args) -> Config:
    cfg = preset("vaegan_paper")
    return cfg.replace(data=cfg.data.replace(image_size=args.image_size,
                                             batch_size=args.batch),
                       train=cfg.train.replace(dtype=args.dtype))


def feature_shape(cfg: Config, batch: int):
    """The Dis_l tap's shape in the JAX layout: (B, h, w, C) for ``res_out``
    and ``pool``, (B, F) for ``fc1`` (the critic's strides and widths)."""
    d = cfg.discriminator
    s = -(-cfg.data.image_size // d.num_stride_conv1)    # pad-1 3x3 stride conv: ceil-div
    for st in d.num_strides_res:
        s = -(-s // st)
    if d.feature_tap == "res_out":
        return (batch, s, s, d.num_features_res[-1])
    if d.feature_tap == "pool":
        return (batch, s // d.pool_size, s // d.pool_size, d.num_features_res[-1])
    return (batch, d.linear_widths[0])


def ideal_bytes(latent, feat_shape, bpe: int):
    """(aggressive, conservative) fully fused bytes (the JAX script's
    formulas) for a latent (b, h, w, c) and the Dis_l features' shape."""
    b, h, w, c = latent
    latent_b = b * h * w * c * bpe
    feat_b = 1
    for s in feat_shape:
        feat_b *= s
    feat_b *= bpe
    # aggressive: one fused pass, 3 latent reads (mu, lv, z_cot) + 2 feature
    # reads; writes z + dmu + dlv (latent) and df_real + df_tilde (features)
    ideal_aggr = (3 + 3) * latent_b + (2 + 2) * feat_b
    # conservative: a separate backward pass re-reads each forward input once
    ideal_cons = ideal_aggr + 2 * latent_b + 2 * feat_b
    return ideal_aggr, ideal_cons


def loss_section(cfg: Config, pallas: bool):
    """``fn(mu, lv, f_real, f_tilde, lr_, lt_, lp_, z_cot, seed)`` -> the
    gradients in (mu, lv, f_real, f_tilde): the paper step's loss math, its
    weighting, and sum(z * z_cot) for the decoder's cotangent. mu and lv are
    NCHW in channels_last (the code processor's layout)."""
    lcfg, gamma = cfg.loss, cfg.optim.gamma
    dt = DTYPES[cfg.train.dtype]

    def reparam(mu, lv, seed):
        if pallas:
            return fused.reparam_kl(mu, lv, seed)[0]
        eps = torch.randn(mu.shape, generator=torch.Generator(device=mu.device).manual_seed(seed),
                          device=mu.device, dtype=mu.dtype)
        return mu + torch.exp(0.5 * lv) * eps

    def fn(mu, lv, f_real, f_tilde, lr_, lt_, lp_, z_cot, seed):
        with torch.enable_grad(), precision(dt):
            inputs = [t.detach().requires_grad_() for t in (mu, lv, f_real, f_tilde)]
            mu, lv, f_real, f_tilde = inputs
            z = reparam(mu, lv, seed)
            l_prior = losses.kl_divergence(mu, lv, lcfg.kl_reduction)
            l_llike = losses.feature_matching_loss(f_real, f_tilde)
            bce_real = losses.bce_with_logits(lr_, 1.0)
            bce_fake = losses.bce_with_logits(lt_, 0.0) + losses.bce_with_logits(lp_, 0.0)
            l_gan = bce_real + bce_fake
            enc_l = lcfg.kl_weight * l_prior + lcfg.reconstruction_weight * l_llike
            dec_l = (gamma * lcfg.reconstruction_weight * l_llike
                     - lcfg.adversarial_weight * l_gan)
            dis_l = lcfg.adversarial_weight * l_gan
            total = enc_l + dec_l + dis_l + torch.sum(z * z_cot.to(z.dtype))
            return torch.autograd.grad(total, inputs)
    return fn


def section_inputs(cfg: Config, dev: torch.device):
    """The section's inputs at the config's shapes, from seed 0."""
    dt = DTYPES[cfg.train.dtype]
    b = cfg.data.batch_size
    h, w, c = latent_shape(cfg, cfg.data.image_size)
    g = torch.Generator().manual_seed(0)

    def latent():
        t = torch.randn((b, c, h, w), generator=g).to(dev, dt)
        return t.contiguous(memory_format=torch.channels_last)

    feat = feature_shape(cfg, b)
    mu, lv, z_cot = latent(), 0.1 * latent(), latent()
    f_real, f_tilde = (torch.randn(feat, generator=g).to(dev, dt) for _ in range(2))
    lr_, lt_, lp_ = (torch.randn((b, 1), generator=g).to(dev, dt) for _ in range(3))
    return (mu, lv, f_real, f_tilde, lr_, lt_, lp_, z_cot), feat


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    cfg = build_config(args)
    dev = resolve_device(args.device)
    b = args.batch
    h, w, c = latent_shape(cfg, args.image_size)
    inputs, feat = section_inputs(cfg, dev)
    fn = loss_section(cfg, args.pallas)
    cost = step_cost(fn, *inputs, 1)
    if args.hlo:
        Path(args.hlo).write_text("".join(f"{n}\t{nb}\n" for n, nb in cost["ops"]))
    measured = cost["bytes accessed"]
    bpe = torch.tensor([], dtype=DTYPES[args.dtype]).element_size()
    ideal_aggr, ideal_cons = ideal_bytes((b, h, w, c), feat, bpe)
    by_op = Counter()
    for name, nbytes in cost["ops"]:
        by_op[name] += nbytes
    record = {
        "backend": dev.type,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "operating_point": f"{args.image_size}^2 batch {b} {args.dtype}"
                           + (", fused reparam_kl" if args.pallas else ""),
        "latent_shape": [b, h, w, c],
        "dis_l_feature_shape": list(feat),
        "measured_bytes_MB": round(measured / 1e6, 1),
        "ideal_fused_MB_aggressive": round(ideal_aggr / 1e6, 1),
        "ideal_fused_MB_conservative": round(ideal_cons / 1e6, 1),
        "ratio_vs_aggressive": round(measured / ideal_aggr, 2),
        "ratio_vs_conservative": round(measured / ideal_cons, 2),
        "ms": (round(cuda_ms(lambda i: fn(*inputs, i)), 4) if dev.type == "cuda" else None),
        "kernel_calls": {k: v["calls"] for k, v in cost["kernels"].items()},
        "bytes_MB_by_op": {k: round(v / 1e6, 1) for k, v in by_op.most_common()},
    }
    print(json.dumps(record, indent=1), flush=True)
    return record


if __name__ == "__main__":
    main()
