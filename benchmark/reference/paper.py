"""Larsen et al.'s Algorithm 1 (arXiv:1512.09300) in plain PyTorch, float32.

One step, over one graph:

1. the generator's training forward on the batch: x~, mu, log_var;
2. a prior sample z_p ~ N(0, I) of the code's shape, and its training decode
   x_p = Dec(z_p) (its own dropout draws; its batch-norm updates after x~'s);
3. the critic on the real batch, on x~ and on x_p, each with its Dis_l
   features, the ``res_out`` tap (the last residual stage's output);
4. L_prior = KL(q(z|x) || N(0, I)) / batch, L_llike = the MSE between the real
   and the x~ features, L_GAN = BCE(D(x), 1) + BCE(D(x~), 0) + BCE(D(x_p), 0);
5. three losses, each differentiated in its own group's parameters over that
   one graph: enc_l = w_kl L_prior + w_rec L_llike (encoder and code head),
   dec_l = gamma w_rec L_llike - w_adv L_GAN (decoder), dis_l = w_adv L_GAN
   (critic);
6. RMSprop on the encoder and decoder as one optimizer (an elementwise rule,
   so one optimizer over both groups is two), RMSprop on the critic, then the
   generator EMA. No clamp: the critic is a BCE discriminator.

Departures from the paper, all the configuration's:
- the networks are the Don-Yin/VAE-GAN notebook's residual ones
  (``reference.model``): a pre-activation residual VAE with a spatial code,
  and a spectrally normalised residual critic with channel dropout
  (``Dropout2d``) and a 131,072-wide linear head at 256², not the paper's
  plain convolutional stacks;
- the KL is the mean over the batch of each image's sum, not the sum;
- with ``dis_l_shared_dropout`` the real and x~ critic forwards use one
  channel-dropout draw (so the features compare like with like) and x_p draws
  its own;
- RMSprop at lr 3e-4 with the notebook's weight decay 1e-5, and a generator EMA
  of 0.999.

The draws are the system's, taken in its order: the kernel seeds of the x~
forward (one per block, the noise's after the encoder's), then those of the
prior decode (one per decoder block); z_p from the device generator seeded
with the step seed, before the critic's channel-dropout masks, which the x~
forward takes again from the real forward's generator state.
"""

from __future__ import annotations

from typing import Iterator, Optional

import torch
import torch.nn.functional as F

from reference import draws as rd
from reference import model as rm
from reference import train as rt
from reference.precision import computed_in

Tensors = rt.Tensors


def _decoder_blocks(cfg: dict):
    blocks = rm.generator_blocks(cfg["generator"])
    return blocks[rm.n_encoder_blocks(cfg["generator"]):]


def decode(cfg: dict, net: rm.Net, z_nhwc: torch.Tensor, seeds: Iterator[int]) -> torch.Tensor:
    """The training decode of a code (B, h, w, C) to images (B, H, W, C),
    one kernel seed per block."""
    p = cfg["generator"]["dropout_prob"]
    h = z_nhwc.permute(0, 3, 1, 2)
    for path, mode, _, _ in _decoder_blocks(cfg):
        h = rm.res_block_vae(net, h, path, mode, p, True, next(seeds))
    return h.permute(0, 2, 3, 1)


def critic(cfg: dict, net: rm.Net, x_nhwc: torch.Tensor,
           draws: Optional[torch.Generator]):
    """The critic's training forward: logits (B, 1) and the ``res_out``
    features (B, h, w, C)."""
    d = cfg["discriminator"]
    if d["feature_tap"] != "res_out":
        raise ValueError("the reference taps the critic's features at res_out only")
    rate = d["dropout_prob"]
    x = x_nhwc.permute(0, 3, 1, 2)
    out = net.conv(x, net.p["conv1.weight"], d["num_stride_conv1"], 1)
    out = net.act(F.leaky_relu(net.bn(out, "bn1", True), 0.2))
    for path, cin, cout, stride in rm.critic_stages(d):
        if f"{path}.shortcut.0.weight_orig" in net.p:
            sc = net.bn(net.conv(out, net.sn_weight(f"{path}.shortcut.0", True), stride, 0),
                        f"{path}.shortcut.1", True)
        else:
            sc = out
        h = net.act(F.leaky_relu(net.bn(out, f"{path}.bn1", True), 0.2))
        h = net.conv(h, net.sn_weight(f"{path}.conv1", True), stride, 1)
        if rate > 0.0:
            keep = torch.empty((h.shape[0], h.shape[1], 1, 1), device=h.device).bernoulli_(
                1.0 - rate, generator=draws).bool()
            h = net.act(torch.where(keep, h / (1.0 - rate), torch.zeros((), device=h.device)))
        h = net.act(F.leaky_relu(net.bn(h, f"{path}.bn2", True), 0.2))
        h = net.conv(h, net.sn_weight(f"{path}.conv2", True), 1, 1)
        out = net.act(h + sc)
    features = out.permute(0, 2, 3, 1)
    out = net.act(F.avg_pool2d(out, d["pool_size"])).reshape(out.shape[0], -1)
    n = len(d["linear_widths"]) + 1
    for j in range(1, n):
        out = net.act(F.leaky_relu(net.linear(out, f"linear_{j}"), 0.2))
    return net.linear(out, f"linear_{n}"), features


def _grads(loss: torch.Tensor, params: Tensors, retain: bool) -> Tensors:
    gs = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                             retain_graph=retain)
    return {k: torch.zeros_like(p) if g is None else g for (k, p), g in zip(params.items(), gs)}


def _refuse(cfg: dict) -> None:
    loss, opt, g = cfg["loss"], cfg["optim"], cfg["generator"]
    if (opt["scheme"] != "three" or loss["adversarial"] != "bce"
            or loss["reconstruction"] != "dis_l" or opt["optimizer"] != "rmsprop"
            or not g["is_vae"] or cfg["train"]["grad_accum"] != 1
            or cfg["train"]["critic_batching"] != "separate"):
        raise ValueError("the reference step is Larsen et al.'s Algorithm 1: three optimizers, "
                         "BCE, Dis_l features, RMSprop, one batch, a critic forward per batch")


def step(cfg: dict, st: rt.State, batch: torch.Tensor, seed: int,
         precision: str = "fp32") -> rt.StepOut:
    """One step from ``st`` (not modified) on ``batch`` (B, H, W, C) with the
    step seed ``seed``, computed in ``precision`` (``reference.precision``)."""
    _refuse(cfg)
    with computed_in(precision, batch.device) as lower:
        return _step(cfg, st, batch, seed, lower)


def _step(cfg: dict, st: rt.State, batch: torch.Tensor, seed: int, lower) -> rt.StepOut:
    loss_c, opt = cfg["loss"], cfg["optim"]
    dev = batch.device
    gp_ = {k: v.detach().clone().requires_grad_(True) for k, v in st.gp.items()}
    dp_ = {k: v.detach().clone().requires_grad_(True) for k, v in st.dp.items()}
    gb = {k: v.clone() for k, v in st.gb.items()}
    db = {k: v.clone() for k, v in st.db.items()}
    gnet, dnet = rm.Net(gp_, gb, lower), rm.Net(dp_, db, lower)
    n_seeds = rm.n_draw_sites(cfg) + len(_decoder_blocks(cfg))
    seeds = iter(rd.site_seeds(seed, n_seeds))
    # a count of operations runs on the meta device, which has no generator
    draws = None if dev.type == "meta" else torch.Generator(device=dev).manual_seed(seed)

    x_tilde, mu, lv = rm.generator(cfg, gnet, batch, True, seeds)
    z_p = torch.randn(mu.shape, generator=draws, device=dev)
    x_p = decode(cfg, gnet, z_p, seeds)
    shared = loss_c["dis_l_shared_dropout"] and draws is not None
    rewind = draws.get_state() if shared else None
    l_real, f_real = critic(cfg, dnet, batch, draws)
    if shared:
        draws.set_state(rewind)
    l_tilde, f_tilde = critic(cfg, dnet, x_tilde, draws)
    l_p, _ = critic(cfg, dnet, x_p, draws)

    b = batch.shape[0]
    l_prior = -0.5 * torch.sum(1.0 + lv - mu * mu - torch.exp(lv))
    if loss_c["kl_reduction"] == "mean":
        l_prior = l_prior / b
    l_llike = torch.mean((f_tilde - f_real) ** 2)
    bce = F.binary_cross_entropy_with_logits
    bce_real = bce(l_real, torch.ones_like(l_real))
    bce_fake = bce(l_tilde, torch.zeros_like(l_tilde)) + bce(l_p, torch.zeros_like(l_p))
    l_gan = bce_real + bce_fake
    w_adv, w_rec = loss_c["adversarial_weight"], loss_c["reconstruction_weight"]
    enc_l = loss_c["kl_weight"] * l_prior + w_rec * l_llike
    dec_l = opt["gamma"] * w_rec * l_llike - w_adv * l_gan
    dis_l = w_adv * l_gan

    enc = {k: v for k, v in gp_.items() if not k.startswith("decoder.")}
    dec = {k: v for k, v in gp_.items() if k.startswith("decoder.")}
    g_raw = {**_grads(enc_l, enc, True), **_grads(dec_l, dec, True)}
    d_raw = _grads(dis_l, dp_, False)

    new = rt.State({}, gb, {}, db, dict(st.g_sq), dict(st.d_sq),
                   None if st.ema is None else dict(st.ema))
    with torch.no_grad():
        new.gp = {k: v.detach() for k, v in gp_.items()}
        new.dp = {k: v.detach() for k, v in dp_.items()}
        g_taken = rt._rmsprop(opt, new.gp, {k: g_raw[k].detach() for k in gp_}, new.g_sq,
                              rt._lr(opt, "g"))
        d_taken = rt._rmsprop(opt, new.dp, {k: g.detach() for k, g in d_raw.items()},
                              new.d_sq, rt._lr(opt, "d"))
        if cfg["train"]["ema_decay"] is not None:
            d = cfg["train"]["ema_decay"]
            new.ema = {k: d * new.ema[k] + (1.0 - d) * v for k, v in new.gp.items()}
    losses = {"d_loss": dis_l, "d_real_loss": bce_real, "d_fake_loss": bce_fake,
              "gp": torch.zeros((), device=dev), "g_loss": enc_l + dec_l, "adv_loss": l_gan,
              "recon_loss": l_llike, "kl": l_prior}
    return rt.StepOut({k: v.detach() for k, v in losses.items()}, g_taken, d_taken, new)


def step_flops(cfg: dict, batch: int) -> int:
    """Operations of one step at this batch and the configuration's image size
    (``FlopCounterMode`` over :func:`step` on the meta device): the generator's
    forward, the prior decode, the critic's three forwards and the three
    gradient passes."""
    from torch.utils.flop_counter import FlopCounterMode

    def meta(spec):
        p = {n: torch.empty(s, device="meta") for n, s, k in spec if rm.is_param(k)}
        b = {n: torch.empty(s, device="meta") for n, s, k in spec if not rm.is_param(k)}
        return p, b

    gp, gb = meta(rm.generator_spec(cfg))
    dp, db = meta(rm.critic_spec(cfg))
    s = cfg["data"]["image_size"]
    x = torch.empty((batch, s, s, cfg["generator"]["in_channels"]), device="meta")
    ema = dict(gp) if cfg["train"]["ema_decay"] is not None else None
    with FlopCounterMode(display=False) as fc:
        step(cfg, rt.State(gp, gb, dp, db, ema=ema), x, 0)
    return int(fc.get_total_flops())
