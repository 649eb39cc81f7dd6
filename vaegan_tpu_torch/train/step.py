"""The two-optimizer train step (port of ``vaegan_tpu/train/step.py::make_train_step``).

One step is the reference's per-batch procedure, in its event order:

D half (every step):
  1. one generator forward (train mode) producing gen_imgs;
  2. the critic on the real batch, on the detached fakes, and the gradient
     penalty on the interpolates (each forward advances the critic's BN running
     statistics and spectral u/v, as torch train-mode forwards do);
  3. RMSprop on the critic, then a clamp of every critic parameter to
     ±clip_value (the reference clamps on top of the GP).

G half (on ``do_g_update`` steps, every ``n_critics``-th):
  4. the SAME gen_imgs, with the generator forward's graph kept alive, scored by
     the UPDATED critic (whose forward advances its BN and SN state again);
  5. g_loss = w_adv * adv + w_rec * (L1 + MSE) + w_kl * KL; its gradients are
     taken in the generator's parameters only (``torch.autograd.grad``), so
     nothing reaches the critic's next update.

On critic-only steps the returned G metrics are the previous step's, as the
reference prints them. Metrics stay on the device: a step never syncs with the
host. A float32 step runs under ``layers.ieee_float32``, so its backward and the
penalty's double backward convolve in IEEE float32 too, not only its forwards.

Random draws come from ``seed``: the fused kernels' seeds from a CPU generator,
the unfused dropout masks, noise and GP alphas from a generator on the batch's
device. ``inject`` replaces draws with given tensors, as the JAX step's does, so
one step can be held number for number against the JAX package's:
``eps`` (B, h, w, C) noise, ``alpha`` (B,) GP mixing factors, and keep-masks
``{module path: NCHW mask}`` per forward: ``g_masks`` (generator),
``d_masks_real`` / ``d_masks_fake`` / ``d_masks_interp`` / ``d_masks_gen``
(the critic's four forwards). :func:`fused_draws` gives a fused step's own draws
in that form.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from vaegan_tpu_torch import losses
from vaegan_tpu_torch.config import Config, pallas_mode
from vaegan_tpu_torch.models import ResBlockVAE, UnsupervisedGeneratorNetwork, inject_masks
from vaegan_tpu_torch.models.layers import precision
from vaegan_tpu_torch.ops import fused
from vaegan_tpu_torch.train.state import DTYPES, G_METRICS, TrainState

Metrics = Dict[str, torch.Tensor]


def lazy_gp_enabled(cfg: Config) -> bool:
    """Whether ``cfg.train.gp_every > 1`` engages the lazy-GP schedule: only the
    two-optimizer WGAN step with an active penalty has a GP term to amortize."""
    return (cfg.train.gp_every > 1 and cfg.optim.scheme != "three"
            and cfg.loss.adversarial == "wgan" and cfg.loss.lambda_gp > 0.0)


def make_step_variants(cfg: Config, builder) -> dict:
    """The ``(do_g_update, do_gp) -> step`` dict a loop schedules.
    ``builder(do_g_update, do_gp, gp_lambda_scale)`` builds one variant; the
    no-GP variants (and λ·gp_every on GP steps) are there exactly when
    :func:`lazy_gp_enabled`."""
    lazy = lazy_gp_enabled(cfg)
    scale = float(cfg.train.gp_every) if lazy else 1.0
    variants = {(True, True): builder(True, True, scale),
                (False, True): builder(False, True, scale)}
    if lazy:
        variants[(True, False)] = builder(True, False, scale)
        variants[(False, False)] = builder(False, False, scale)
    return variants


@torch.no_grad()
def _ema_update(cfg: Config, g_ema: Optional[Dict[str, torch.Tensor]],
                generator: UnsupervisedGeneratorNetwork) -> None:
    """g_ema <- d * g_ema + (1 - d) * params, in place (no-op without an EMA)."""
    d = cfg.train.ema_decay
    if d is None or g_ema is None:
        return
    for k, p in generator.named_parameters():
        g_ema[k].mul_(d).add_((1.0 - d) * p)


def fused_draws(generator: UnsupervisedGeneratorNetwork) -> Dict[str, object]:
    """The random draws of the generator's last fused train forward, as an
    ``inject`` for an unfused step: ``g_masks`` (each fused dropout site's
    Philox keep-mask, at the path of the block's Dropout module) and ``eps`` (the
    ``reparam_kl`` noise, (B, h, w, C)), rebuilt with the plain versions from the
    recorded seeds."""
    dev = next(generator.parameters()).device
    out: Dict[str, object] = {}
    masks = {}
    for name, m in generator.named_modules():
        if isinstance(m, ResBlockVAE) and m.use_pallas and m.p > 0.0:
            seed, shape = m.bn1.last_draw
            x = torch.empty(shape, device=dev).contiguous(memory_format=torch.channels_last)
            masks[f"{name}.dropout"] = fused.keep_mask(x, seed, m.p)
    if masks:
        out["g_masks"] = masks
    cp = generator.code_processor
    if cp is not None and cp.last_draw is not None:
        seed, shape = cp.last_draw
        out["eps"] = fused.reparam_noise(shape, seed, dev).permute(0, 2, 3, 1)
    return out


def _grads(loss: torch.Tensor, params) -> Tuple[torch.Tensor, ...]:
    """d loss / d params; a parameter the loss does not reach gets zeros (as a
    JAX gradient tree would), so the optimizer still decays it."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return tuple(torch.zeros_like(p) if g is None else g for p, g in zip(params, grads))


def _apply(opt: torch.optim.Optimizer, params, grads) -> None:
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    for p in params:
        p.grad = None


def _critic_loss(cfg: Config, critic, batch, gen_sg, draws, inject, do_gp: bool,
                 gp_lambda_scale: float):
    """D-half loss: critic on real, on detached fakes, gradient penalty on the
    interpolates. Returns (d_loss, real_loss, fake_loss, gp)."""
    lcfg = cfg.loss
    use_gp = do_gp and lcfg.adversarial == "wgan" and lcfg.lambda_gp > 0.0

    def d(x, masks):
        with inject_masks(critic, masks):
            return critic(x, train=True, generator=draws)

    real_logits = d(batch, inject.get("d_masks_real"))
    fake_logits = d(gen_sg, inject.get("d_masks_fake"))
    if lcfg.adversarial == "bce":
        real_loss = losses.bce_with_logits(real_logits, 1.0)
        fake_loss = losses.bce_with_logits(fake_logits, 0.0)
    else:  # wgan (also "none": the critic still trains, unused by G)
        real_loss, fake_loss = losses.wgan_critic_loss(real_logits, fake_logits)
    if use_gp:
        b = batch.shape[0]
        alpha = inject.get("alpha")
        if alpha is None:
            alpha = torch.rand((b, 1, 1, 1), generator=draws, device=batch.device)
        gp = losses.gradient_penalty(lambda x: d(x, inject.get("d_masks_interp")),
                                     batch, gen_sg, torch.as_tensor(alpha, device=batch.device))
    else:
        gp = torch.zeros((), device=batch.device)
    d_loss = real_loss + fake_loss + lcfg.lambda_gp * gp_lambda_scale * gp
    return d_loss, real_loss, fake_loss, gp


def _gen_losses(cfg: Config, critic, batch, g_imgs, mu, lv, draws, inject):
    """G-half loss. The reference runs the critic on gen_imgs even at adversarial
    weight 0 (its forward still advances BN and SN state); only the port's and
    the JAX package's own ``adversarial="none"`` skips it. Returns
    (g_loss, adv, recon, kl)."""
    lcfg = cfg.loss
    want_feats = lcfg.reconstruction == "dis_l"
    no_adv = lcfg.adversarial == "none"
    adv = torch.zeros((), device=batch.device)
    if not (no_adv and not want_feats):
        with inject_masks(critic, inject.get("d_masks_gen")):
            out = critic(g_imgs, train=True, return_features=want_feats, generator=draws)
        logits, feats = out if want_feats else (out, None)
        if lcfg.adversarial == "bce":
            adv = losses.bce_with_logits(logits, 1.0)
        elif not no_adv:
            adv = losses.wgan_generator_loss(logits)
    if want_feats:
        _, real_feats = critic(batch, train=True, return_features=True, generator=draws)
        recon = losses.feature_matching_loss(real_feats.detach(), feats)
    elif pallas_mode(cfg.train.use_pallas) in ("losses", "all"):
        sums = fused.recon_loss_sums(g_imgs, batch)
        recon = (sums[0] + sums[1]) / g_imgs.numel()
    else:
        recon = losses.pixel_reconstruction_loss(g_imgs, batch)
    kl = losses.kl_divergence(mu, lv, lcfg.kl_reduction)
    g_loss = (lcfg.adversarial_weight * adv + lcfg.reconstruction_weight * recon
              + lcfg.kl_weight * kl)
    return g_loss, adv, recon, kl


def make_train_step(cfg: Config, do_g_update: bool,
                    inject: Optional[Dict[str, object]] = None, do_gp: bool = True,
                    gp_lambda_scale: float = 1.0) -> Callable:
    """The notebook's two-optimizer step. Returns
    ``step(state, batch, seed) -> (state, metrics)``: ``batch`` is (B, H, W, C) on
    the state's device, ``seed`` an int that decides every random draw; the state
    is updated in place and returned.

    ``do_gp=False`` is the lazy-regularization off-step (no penalty, no
    grad-of-grad); ``gp_lambda_scale`` multiplies ``loss.lambda_gp`` and is set by
    the scheduler that skips GP steps (:func:`make_step_variants`), never derived
    from the config here. ``inject``: see the module docstring; ``g_masks`` with
    ``use_pallas="all"`` raises, because the fused kernel draws its own masks.
    """
    if cfg.train.grad_accum > 1:
        raise NotImplementedError("grad_accum > 1 is still to be ported (ROADMAP.md)")
    if cfg.train.critic_batching != "separate":
        raise NotImplementedError(f"critic_batching={cfg.train.critic_batching!r} is still "
                                  "to be ported (ROADMAP.md); use 'separate'")
    inject = dict(inject or {})
    if "g_masks" in inject and pallas_mode(cfg.train.use_pallas) == "all":
        raise ValueError(
            "dropout-mask injection (g_masks) is incompatible with use_pallas='all' "
            "(the fused block kernel draws its own masks); use use_pallas='losses' or "
            "'off' for parity replays")
    dtype = DTYPES[cfg.train.dtype]
    clip = cfg.loss.clip_value

    def step(state: TrainState, batch: torch.Tensor, seed: int) -> Tuple[TrainState, Metrics]:
        gen, critic = state.generator, state.critic
        dev = batch.device
        seeds = torch.Generator().manual_seed(seed)
        draws = torch.Generator(device=dev).manual_seed(seed)
        eps = inject.get("eps")
        with precision(dtype):
            # ---- generator forward, ONCE; its graph serves the G half ----------
            with torch.set_grad_enabled(do_g_update), inject_masks(gen, inject.get("g_masks")):
                out = gen(batch, train=True, generator=draws, seeds=seeds,
                          eps=None if eps is None else torch.as_tensor(eps, device=dev))
            if cfg.generator.is_vae:
                gen_imgs, mu, lv = out
            else:
                gen_imgs = out
                mu = lv = torch.zeros((batch.shape[0], 1), device=dev)
            gen_sg = gen_imgs.detach()

            # ---- discriminator half --------------------------------------------
            d_params = list(critic.parameters())
            d_loss, real_loss, fake_loss, gp = _critic_loss(
                cfg, critic, batch, gen_sg, draws, inject, do_gp, gp_lambda_scale)
            _apply(state.opt_d, d_params, _grads(d_loss, d_params))
            if clip is not None:
                with torch.no_grad():
                    for p in d_params:
                        p.clamp_(-clip, clip)

            # ---- generator half, scored by the UPDATED critic ------------------
            if do_g_update:
                g_loss, adv, recon, kl = _gen_losses(cfg, critic, batch, gen_imgs, mu, lv,
                                                     draws, inject)
                g_params = list(gen.parameters())
                _apply(state.opt_g, g_params, _grads(g_loss, g_params))
                _ema_update(cfg, state.g_ema, gen)
                state.g_metrics = dict(zip(G_METRICS, (t.detach() for t in
                                                       (g_loss, adv, recon, kl))))
        state.step += 1
        metrics = {"d_loss": d_loss.detach(), "d_real_loss": real_loss.detach(),
                   "d_fake_loss": fake_loss.detach(), "gp": gp.detach(), **state.g_metrics}
        return state, metrics

    return step
