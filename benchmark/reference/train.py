"""The notebook's two-optimizer WGAN-GP step in plain PyTorch, float32.

One step (the notebook's per-batch procedure, ``README.md`` 792-831):

1. the generator's training forward on the batch, its graph kept;
2. the critic on the real batch, on the detached fakes and on the
   interpolates alpha x + (1 - alpha) x~, whose input gradient gives the
   penalty E[(||g|| - 1)^2] (a double backward in the critic's parameters);
3. d_loss = -E[D(x)] + E[D(x~)] + lambda_gp * gp; RMSprop on the critic, then
   every critic parameter clamped to +-clip;
4. the same fakes scored by the updated critic: g_loss = w_adv (-E[D(x~)]) +
   w_rec (L1 + MSE) + w_kl KL (summed); RMSprop on the generator; the
   generator EMA, when configured.

RMSprop is torch's: g <- g + wd p, s <- a s + (1 - a) g^2, p <- p - lr g /
(sqrt(s) + eps). The critic's channel-dropout masks and the penalty's alphas
are drawn from a device generator seeded with the step seed, in the order the
step consumes them; the generator's dropout and noise from the kernel seeds
(``reference.draws``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from reference import draws as rd
from reference import model as rm
from reference.precision import Hooks, computed_in

Tensors = Dict[str, torch.Tensor]


@dataclass
class State:
    """What a step reads and writes: parameters, buffers, RMSprop square
    averages (empty before the first step) and the EMA (or None)."""

    gp: Tensors
    gb: Tensors
    dp: Tensors
    db: Tensors
    g_sq: Tensors = field(default_factory=dict)
    d_sq: Tensors = field(default_factory=dict)
    ema: Optional[Tensors] = None


@dataclass
class StepOut:
    """A step's losses, the gradients as each optimizer got them (weight decay
    included) and the state after it."""

    losses: Tensors
    g_grads: Tensors
    d_grads: Tensors
    state: State


def _rmsprop(o: dict, params: Tensors, grads: Tensors, sq: Tensors, lr: float) -> Tensors:
    """Updated parameters and square averages (new tensors); returns the
    gradients as the optimizer took them."""
    taken = {}
    for k, p in params.items():
        g = grads[k] + o["weight_decay"] * p
        s = o["rms_decay"] * sq[k] + (1.0 - o["rms_decay"]) * g * g if k in sq else \
            (1.0 - o["rms_decay"]) * g * g
        params[k] = p - lr * g / (torch.sqrt(s) + o["eps"])
        sq[k] = s
        taken[k] = g
    return taken


def _lr(o: dict, role: str) -> float:
    v = o.get(f"lr_{role}")
    return o["lr"] if v is None else v


def _grads(loss, params: Tensors) -> Tensors:
    gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), gs)}


def step(cfg: dict, st: State, batch: torch.Tensor, seed: int,
         precision: str = "fp32") -> StepOut:
    """One step from ``st`` (not modified) on ``batch`` (B, H, W, C) with the
    step seed ``seed``, computed in ``precision`` (``reference.precision``:
    IEEE float32 unless a control asks for less)."""
    with computed_in(precision, batch.device) as lower:
        return _step(cfg, st, batch, seed, lower)


def _step(cfg: dict, st: State, batch: torch.Tensor, seed: int, lower: Hooks) -> StepOut:
    loss_c, opt, tc = cfg["loss"], cfg["optim"], cfg["train"]
    if (loss_c["adversarial"] != "wgan" or opt["scheme"] != "two"
            or opt["optimizer"] != "rmsprop" or tc["n_critics"] != 1):
        raise ValueError("the reference step is the notebook's WGAN-GP step with RMSprop, "
                         "the generator updated every step")
    dev = batch.device
    gp_ = {k: v.detach().clone().requires_grad_(True) for k, v in st.gp.items()}
    dp_ = {k: v.detach().clone().requires_grad_(True) for k, v in st.dp.items()}
    gb = {k: v.clone() for k, v in st.gb.items()}
    db = {k: v.clone() for k, v in st.db.items()}
    gnet, dnet = rm.Net(gp_, gb, lower), rm.Net(dp_, db, lower)
    seeds = iter(rd.site_seeds(seed, rm.n_draw_sites(cfg)))
    # a count of operations runs on the meta device, which has no generator
    draws = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)

    fake, mu, lv = rm.generator(cfg, gnet, batch, True, seeds)
    fake_sg = fake.detach()
    real_logits = rm.critic(cfg, dnet, batch, True, draws)
    fake_logits = rm.critic(cfg, dnet, fake_sg, True, draws)
    b = batch.shape[0]
    alpha = torch.rand((b, 1, 1, 1), generator=draws, device=dev)
    interp = (alpha * batch + (1.0 - alpha) * fake_sg).requires_grad_(True)
    (gi,) = torch.autograd.grad(rm.critic(cfg, dnet, interp, True, draws).sum(), interp,
                                create_graph=True)
    gp = torch.mean((torch.sqrt(torch.sum(gi.reshape(b, -1) ** 2, dim=1) + 1e-24) - 1.0) ** 2)
    real_loss, fake_loss = -torch.mean(real_logits), torch.mean(fake_logits)
    d_loss = real_loss + fake_loss + loss_c["lambda_gp"] * gp
    d_raw = _grads(d_loss, dp_)

    new = State({}, gb, {}, db, dict(st.g_sq), dict(st.d_sq),
                None if st.ema is None else dict(st.ema))
    with torch.no_grad():
        new.dp = {k: v.detach() for k, v in dp_.items()}
        d_taken = _rmsprop(opt, new.dp, {k: g.detach() for k, g in d_raw.items()}, new.d_sq,
                           _lr(opt, "d"))
        if loss_c["clip_value"] is not None:
            c = loss_c["clip_value"]
            new.dp = {k: v.clamp(-c, c) for k, v in new.dp.items()}

    dnet2 = rm.Net(new.dp, db, lower)
    adv = -torch.mean(rm.critic(cfg, dnet2, fake, True, draws))
    diff = fake - batch
    recon = torch.mean(torch.abs(diff)) + torch.mean(diff * diff)
    kl = -0.5 * torch.sum(1.0 + lv - mu * mu - torch.exp(lv))
    if loss_c["kl_reduction"] == "mean":
        kl = kl / b
    g_loss = (loss_c["adversarial_weight"] * adv + loss_c["reconstruction_weight"] * recon
              + loss_c["kl_weight"] * kl)
    g_raw = _grads(g_loss, gp_)
    with torch.no_grad():
        new.gp = {k: v.detach() for k, v in gp_.items()}
        g_taken = _rmsprop(opt, new.gp, {k: g.detach() for k, g in g_raw.items()}, new.g_sq,
                           _lr(opt, "g"))
        if tc["ema_decay"] is not None:
            d = tc["ema_decay"]
            new.ema = {k: d * new.ema[k] + (1.0 - d) * v for k, v in new.gp.items()}
    losses = {"d_loss": d_loss, "d_real_loss": real_loss, "d_fake_loss": fake_loss, "gp": gp,
              "g_loss": g_loss, "adv_loss": adv, "recon_loss": recon, "kl": kl}
    return StepOut({k: v.detach() for k, v in losses.items()}, g_taken, d_taken, new)
