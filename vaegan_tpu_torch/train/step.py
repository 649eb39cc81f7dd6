"""The train steps (port of ``vaegan_tpu/train/step.py``).

``make_train_step`` is the notebook's two-optimizer step. One step is the
reference's per-batch procedure, in its event order:

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
reference prints them.

``make_paper_train_step`` is the Larsen et al. Algorithm-1 step (three
optimizers; the ``vaegan_paper`` preset). One forward, in this order: the
generator on the batch (x~, mu, log_var), a prior sample z_p ~ N(0, I), its
train-mode decode x_p = Dec(z_p) (its own dropout draw; its BN running-statistic
updates come after the x~ forward's), then the critic on the real batch, on x~
and on x_p, each with its Dis_l features. Each group takes the gradient of its
own loss in its own parameters, three ``torch.autograd.grad`` calls over that
one graph:

  enc_l = w_kl * L_prior + w_rec * L_llike            encoder + code processor
  dec_l = gamma * w_rec * L_llike - w_adv * L_GAN     decoder
  dis_l = w_adv * L_GAN                               critic

with L_llike the MSE between the real and x~ features and L_GAN the BCE over
{real: 1, x~: 0, x_p: 0}. This is the JAX step's "explicit" decomposition
(its ``debug_grads`` hook), which the JAX tests hold equal to the one backward
of its stop-gradient form that XLA needs. All three optimizers update after
the losses; the clamp applies to WGAN configs only. With
``loss.dis_l_shared_dropout`` the real and x~ critic forwards use one
``Dropout2d`` draw (the device generator is rewound between them) and x_p draws
its own.

``cfg.train.critic_batching = "concat"`` / ``"concat3"`` (the JAX package's
throughput options; their BN statistics mix the batches, a documented
deviation from the reference) score the critic's batches in one forward:
real and fake in the two-optimizer D half (with ``"concat3"`` and a penalty,
the interpolates too: :func:`_critic_loss`), real, x~ and x_p in the paper
step, which then has no pair of forwards for ``dis_l_shared_dropout`` to
share a draw between. The G half's critic forward is separate in every mode.
Per-forward critic masks cannot be injected under them (``ValueError``).

With ``cfg.train.grad_accum = k > 1`` both ``make_*`` functions return an
accumulating step. The batch is cut into k microbatches; microbatch j draws
from its own seed, :func:`micro_seed` ``(seed, j)``, and the summed gradients
/ k make one update per optimizer. The two-optimizer step runs two passes, the critic's
update between them as in the full step: pass 1 runs each microbatch's
generator forward without a graph and sums the critic's gradients; pass 2
recomputes each forward with the same seeds against the updated critic and
leaves the generator's BN running statistics as pass 1 left them (the critic's
BN and SN state advance in both passes). The paper step needs one pass. A
sum-reduced KL is scaled by k in the microbatch loss, so the mean of the
gradients is the full batch's, and the reported KL is the sum over the
microbatches.

Metrics stay on the device: a step never syncs with the host. Its phases are
spans (``utils.profiling``) timed on the batch's device, in event order:
``step.g_forward``, ``step.d_forward`` (the critic's forwards and the penalty's
input gradient), ``step.d_backward``, ``step.reduce`` (the exchange; no work on
one process), ``step.d_update`` (with the clamp), ``step.g_half``,
``step.g_update``, ``step.ema``, and ``step.reduce`` again for the metrics; the
paper step's ``step.d_update`` holds its three optimizers, its
``step.g_forward`` holds ``step.prior_decode`` (the z_p draw and the decode of
x_p), and its ``step.d_backward`` holds the three gradient passes in turn,
``step.grad_enc``, ``step.grad_dec`` and ``step.grad_dis``. A float32 step
runs under ``layers.ieee_float32``, so its backward and the penalty's double
backward convolve in IEEE float32 too, not only its forwards.

Random draws come from ``seed``: the fused kernels' seeds from a CPU generator,
the unfused dropout masks, noise, prior samples and GP alphas from a generator
on the batch's device. ``inject`` replaces draws with given tensors, as the JAX
step's does, so one step can be held number for number against the JAX
package's: ``eps`` (B, h, w, C) noise, ``alpha`` (B,) GP mixing factors,
``z_p`` (B, h, w, C) prior samples (paper step), and keep-masks ``{module path:
NCHW mask}`` per forward: ``g_masks`` (the generator forward), ``g_masks_p``
(the paper step's prior decode), ``d_masks_real`` / ``d_masks_fake`` /
``d_masks_interp`` / ``d_masks_gen`` (the two-optimizer critic's four forwards)
and ``d_masks_real`` / ``d_masks_tilde`` / ``d_masks_prior`` (the paper
critic's three). :func:`fused_draws` and :func:`paper_draws` give a fused
step's own draws in that form. An accumulating step takes ``eps``, ``alpha``
and ``z_p`` only, cut along the batch like the images.

Data x model parallelism (``replica``, ``ops.replica``;
``parallel.make_parallel_train_step`` builds these steps with the process's
replica). Each process runs the step on its rows of the global batch (and, under
spatial sharding, its stripe of H) and computes what the one-process step
computes on the whole of it: the models' batch statistics are all-reduced,
every draw is the global step's (module ``ops.replica``), and each loss is
written as this process's share of the global loss (``Replica.share`` for a
mean, ``Replica.share_sum`` for a sum such as the notebook's batch-summed KL),
so the sum of all the processes' shares' gradients is the global loss's
gradient. The gradients of each optimizer group are summed between
``torch.autograd.grad`` and the optimizer (DDP reduces only inside
``.backward()``, which these steps do not call): a replicated tensor's over
every process, a critic head kernel split over the model axis (tensor
parallelism, ``layers.Linear.shard``) over the data axis, one all-reduce of one
flat buffer for each; the metrics in one more, so every process reports the
global metrics and applies the same update.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import torch

from vaegan_tpu_torch import losses
from vaegan_tpu_torch.config import Config, pallas_mode
from vaegan_tpu_torch.models import ResBlockVAE, UnsupervisedGeneratorNetwork, inject_masks
from vaegan_tpu_torch.models.layers import Linear, precision
from vaegan_tpu_torch.ops import fused
from vaegan_tpu_torch.ops.replica import LOCAL, Replica
from vaegan_tpu_torch.train.state import DTYPES, G_METRICS, TrainState
from vaegan_tpu_torch.utils.profiling import span

Metrics = Dict[str, torch.Tensor]
DrawRecord = Dict[str, Tuple[int, Tuple[int, ...]]]

_M64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


CONCAT = ("concat", "concat3")


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


def _splitmix64(x: int) -> int:
    x &= _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def step_seed(seed: int, global_step: int) -> int:
    """The int seed of global step ``global_step`` of a run seeded ``seed``:
    splitmix64's finalizer over ``seed * 2**32 + global_step`` (both modulo
    2**32) plus the golden gamma."""
    return _splitmix64((((seed & 0xFFFFFFFF) << 32) | (global_step & 0xFFFFFFFF)) + _GOLDEN)


def micro_seed(seed: int, j: int) -> int:
    """The seed of microbatch ``j`` of an accumulating step seeded ``seed``: the
    (j + 1)-th output of splitmix64 started at ``seed``, so the k microbatches of
    one step draw from k distinct seeds."""
    return _splitmix64(seed + (j + 1) * _GOLDEN)


def _generators(seed: int, dev) -> Tuple[torch.Generator, torch.Generator]:
    """(CPU generator for the fused kernels' seeds, generator on ``dev`` for the
    rest), both seeded ``seed``."""
    return torch.Generator().manual_seed(seed), torch.Generator(device=dev).manual_seed(seed)


@contextlib.contextmanager
def kept_buffers(module: torch.nn.Module):
    """Run the body on clones of ``module``'s buffers and put the originals back
    after: train-mode BN writes its running statistics in place, and a forward
    inside leaves the module's state bitwise as it was."""
    saved = [(m, dict(m._buffers)) for m in module.modules() if m._buffers]
    try:
        for m, bufs in saved:
            for k, v in bufs.items():
                if v is not None:
                    m._buffers[k] = v.clone()
        yield
    finally:
        for m, bufs in saved:
            m._buffers.update(bufs)


@torch.no_grad()
def _ema_update(cfg: Config, g_ema: Optional[Dict[str, torch.Tensor]],
                generator: UnsupervisedGeneratorNetwork) -> None:
    """g_ema <- d * g_ema + (1 - d) * params, in place (no-op without an EMA)."""
    d = cfg.train.ema_decay
    if d is None or g_ema is None:
        return
    for k, p in generator.named_parameters():
        g_ema[k].mul_(d).add_((1.0 - d) * p)


def draw_record(generator: UnsupervisedGeneratorNetwork) -> DrawRecord:
    """``(seed, input shape)`` of each fused dropout site (at the path of the
    block's Dropout module) and of the ``reparam_kl`` noise (``"eps"``), as the
    generator's last fused train forward through each left them (the global
    input's shape in a data-parallel step: the draws are the global step's)."""
    rec: DrawRecord = {}
    for name, m in generator.named_modules():
        if isinstance(m, ResBlockVAE) and m.use_pallas and m.p > 0.0 \
                and m.bn1.last_draw is not None:
            rec[f"{name}.dropout"] = m.bn1.last_draw
    cp = generator.code_processor
    if cp is not None and cp.last_draw is not None:
        rec["eps"] = cp.last_draw
    return rec


def fused_draws(generator: UnsupervisedGeneratorNetwork,
                record: Optional[DrawRecord] = None) -> Dict[str, object]:
    """The random draws of a fused train forward, as an ``inject`` for an
    unfused step: ``g_masks`` (each fused dropout site's Philox keep-mask) and
    ``eps`` (the ``reparam_kl`` noise, (B, h, w, C)), rebuilt with the plain
    versions from ``record`` (default: :func:`draw_record` of the generator's
    last forward)."""
    record = draw_record(generator) if record is None else record
    dev = next(generator.parameters()).device
    out: Dict[str, object] = {}
    masks = {}
    for key, (seed, shape) in record.items():
        if key == "eps":
            out["eps"] = fused.reparam_noise(shape, seed, dev).permute(0, 2, 3, 1)
        else:
            p = generator.get_submodule(key.rsplit(".", 1)[0]).p
            x = torch.empty(shape, device=dev).contiguous(memory_format=torch.channels_last)
            masks[key] = fused.keep_mask(x, seed, p)
    if masks:
        out["g_masks"] = masks
    return out


def paper_draws(step: Callable, generator: UnsupervisedGeneratorNetwork) -> Dict[str, object]:
    """The generator draws of the last call of a fused paper ``step``, as an
    ``inject`` for an unfused one: ``g_masks`` and ``eps`` of the x~ forward,
    ``g_masks_p`` of the prior decode."""
    out = fused_draws(generator, step.draws["x"])
    prior = fused_draws(generator, step.draws["p"]).get("g_masks")
    if prior:
        out["g_masks_p"] = prior
    return out


def _grads(loss: torch.Tensor, params, retain_graph: bool = False) -> Tuple[torch.Tensor, ...]:
    """d loss / d params; a parameter the loss does not reach gets zeros (as a
    JAX gradient tree would), so the optimizer still decays it."""
    grads = torch.autograd.grad(loss, params, allow_unused=True, retain_graph=retain_graph)
    return tuple(torch.zeros_like(p) if g is None else g for p, g in zip(params, grads))


def _split(module: torch.nn.Module) -> set:
    """The ids of ``module``'s parameters that hold a slice over the model axis
    (the critic head's kernels under tensor parallelism)."""
    return {id(m.weight) for m in module.modules() if isinstance(m, Linear) and m.tp[1] > 1}


def _reduce_grads(replica: Replica, params, grads, split=frozenset()):
    """The gradients summed over the processes that hold a copy of their
    parameter: every process for a replicated one, the data axis for one in
    ``split`` (ids of parameters split over the model axis); one all-reduce of
    one flat buffer each (no-op on one process)."""
    if not replica.parallel:
        return grads
    out = list(grads)
    for over, in_split in (("mesh", False), ("data", True)):
        idx = [i for i, p in enumerate(params) if (id(p) in split) == in_split]
        if not idx or replica.axis(over)[1] == 1:
            continue
        part = [out[i] for i in idx]
        flat = replica.all_reduce_(torch._utils._flatten_dense_tensors(part), over)
        for i, v in zip(idx, torch._utils._unflatten_dense_tensors(flat, part)):
            out[i] = v
    return out


def _reduce_metrics(replica: Replica, *groups: Dict[str, torch.Tensor]):
    """Each metric dict summed over the processes (the shares of a global
    metric), in one all-reduce; the dicts as given on one process."""
    if not replica.parallel:
        return groups
    keys = [(i, k) for i, g in enumerate(groups) for k in g]
    flat = replica.all_reduce_(torch.stack([groups[i][k].detach().float().reshape(())
                                            for i, k in keys]), "mesh")
    out = [{} for _ in groups]
    for (i, k), v in zip(keys, flat.unbind(0)):
        out[i][k] = v
    return out


def _kl_share(cfg: Config, replica: Replica, kl: torch.Tensor) -> torch.Tensor:
    """This process's share of the global KL, given its local KL: a sum's
    share, or for a mean over the rows (its local sum over its rows), that
    sum's share over the data axis's rows."""
    kl = replica.share_sum(kl)
    return kl if cfg.loss.kl_reduction == "sum" else kl / replica.world


def _apply(opt: torch.optim.Optimizer, params, grads) -> None:
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    for p in params:
        p.grad = None


def _add(total, terms):
    return list(terms) if total is None else [a + t for a, t in zip(total, terms)]


def _clamp(params, clip: float) -> None:
    with torch.no_grad():
        for p in params:
            p.clamp_(-clip, clip)


def _refuse_fused_masks(cfg: Config, inject: dict, keys) -> None:
    found = [k for k in keys if k in inject]
    if found and pallas_mode(cfg.train.use_pallas) == "all":
        raise ValueError(
            f"dropout-mask injection ({found}) is incompatible with use_pallas='all' "
            "(the fused block kernel draws its own masks); use use_pallas='losses' or "
            "'off' for parity replays")


def _refuse_concat_masks(cfg: Config, inject: dict, keys) -> None:
    found = [k for k in keys if k in inject]
    if found and cfg.train.critic_batching in CONCAT:
        raise ValueError(
            f"per-forward critic masks ({found}) cannot be injected under "
            f"critic_batching={cfg.train.critic_batching!r}: one critic forward scores the "
            "concatenated batches and draws its own masks; use 'separate' for parity replays")


def _micro_injects(inject: dict, allowed, k: int, dev) -> list:
    """``inject`` cut into k per-microbatch dicts along the batch."""
    extra = sorted(set(inject) - set(allowed))
    if extra:
        raise ValueError(f"an accumulating step takes inject keys {sorted(allowed)} only "
                         f"(each microbatch draws its own masks), got {extra}")
    out = [{} for _ in range(k)]
    for key, v in inject.items():
        for j, part in enumerate(torch.as_tensor(v, device=dev).chunk(k)):
            out[j][key] = part
    return out


def _cut(batch: torch.Tensor, k: int):
    b = batch.shape[0]
    if b % k:
        raise ValueError(f"batch size {b} not divisible by grad_accum {k}")
    return batch.chunk(k)


def _gen_forward(cfg: Config, gen, batch, seeds, draws, inject, replica: Replica = LOCAL):
    """The generator's train forward: (gen_imgs, mu, log_var), zeros for a
    non-VAE's mu and log_var."""
    eps = inject.get("eps")
    with inject_masks(gen, inject.get("g_masks")):
        out = gen(batch, train=True, generator=draws, seeds=seeds, replica=replica,
                  eps=None if eps is None else torch.as_tensor(eps, device=batch.device))
    if cfg.generator.is_vae:
        return out
    zeros = torch.zeros((batch.shape[0], 1), device=batch.device)
    return out, zeros, zeros


def _critic_loss(cfg: Config, critic, batch, gen_sg, draws, inject, do_gp: bool,
                 gp_lambda_scale: float, replica: Replica = LOCAL):
    """D-half loss: critic on real, on detached fakes, gradient penalty on the
    interpolates. Returns (d_loss, real_loss, fake_loss, gp), this process's
    shares of them.

    ``cfg.train.critic_batching``: ``"separate"`` runs one critic forward per
    batch, as the reference does; ``"concat"`` scores real and fake in one
    forward over ``cat(real, fake)`` and runs the penalty's forward on its own;
    ``"concat3"`` with a penalty runs one forward over ``cat(real, fake,
    interp)`` and takes the penalty's input gradient through it, so the
    interpolates enter the BN statistics too (without a penalty it is
    ``"concat"``). Each forward advances the critic's BN and SN state once."""
    lcfg = cfg.loss
    use_gp = do_gp and lcfg.adversarial == "wgan" and lcfg.lambda_gp > 0.0
    lam_gp = lcfg.lambda_gp * gp_lambda_scale
    batching = cfg.train.critic_batching
    b = batch.shape[0]

    def d(x, masks=None, parts=1):
        with inject_masks(critic, masks):
            return critic(x, train=True, generator=draws, replica=replica.concat(parts))

    def alpha():
        a = inject.get("alpha")
        if a is None:
            a = replica.draw((b, 1, 1, 1), lambda s: torch.rand(s, generator=draws,
                                                                device=batch.device))
        return torch.as_tensor(a, device=batch.device)

    share = replica.share
    if batching == "concat3" and use_gp:
        interp = losses.interpolates(batch, gen_sg, alpha())
        all3 = d(torch.cat([batch, gen_sg.to(batch.dtype), interp]), parts=3)
        gi = losses.input_gradient(all3[2 * b:], interp, replica)
        gp = share(losses.penalty_of(gi, replica))
        # use_gp implies wgan; a bce critic takes the concat branch below
        real_loss, fake_loss = map(share, losses.wgan_critic_loss(all3[:b], all3[b:2 * b]))
        return real_loss + fake_loss + lam_gp * gp, real_loss, fake_loss, gp

    if batching in CONCAT:
        both = d(torch.cat([batch, gen_sg.to(batch.dtype)]), parts=2)
        real_logits, fake_logits = both[:b], both[b:]
    else:
        real_logits = d(batch, inject.get("d_masks_real"))
        fake_logits = d(gen_sg, inject.get("d_masks_fake"))
    if lcfg.adversarial == "bce":
        real_loss = share(losses.bce_with_logits(real_logits, 1.0))
        fake_loss = share(losses.bce_with_logits(fake_logits, 0.0))
    else:  # wgan (also "none": the critic still trains, unused by G)
        real_loss, fake_loss = map(share, losses.wgan_critic_loss(real_logits, fake_logits))
    if use_gp:
        # the inner gradient is the global logits' sum's: the backward of every
        # collective (BN statistics, halos, the head's gathers) sums every
        # process's part (losses.input_gradient)
        gp = share(losses.gradient_penalty(lambda x: d(x, inject.get("d_masks_interp")),
                                           batch, gen_sg, alpha(), replica))
    else:
        gp = torch.zeros((), device=batch.device)
    d_loss = real_loss + fake_loss + lam_gp * gp
    return d_loss, real_loss, fake_loss, gp


def _gen_losses(cfg: Config, critic, batch, g_imgs, mu, lv, draws, inject,
                kl_scale: float = 1.0, replica: Replica = LOCAL):
    """G-half loss. The reference runs the critic on gen_imgs even at adversarial
    weight 0 (its forward still advances BN and SN state); only the port's and
    the JAX package's own ``adversarial="none"`` skips it. ``kl_scale`` scales
    the KL term (accumulation's sum-reduced KL). Returns (g_loss, adv, recon,
    kl), this process's shares of them."""
    lcfg = cfg.loss
    want_feats = lcfg.reconstruction == "dis_l"
    no_adv = lcfg.adversarial == "none"
    adv = torch.zeros((), device=batch.device)
    if not (no_adv and not want_feats):
        with inject_masks(critic, inject.get("d_masks_gen")):
            out = critic(g_imgs, train=True, return_features=want_feats, generator=draws,
                         replica=replica)
        logits, feats = out if want_feats else (out, None)
        if lcfg.adversarial == "bce":
            adv = losses.bce_with_logits(logits, 1.0)
        elif not no_adv:
            adv = losses.wgan_generator_loss(logits)
    if want_feats:
        _, real_feats = critic(batch, train=True, return_features=True, generator=draws,
                               replica=replica)
        recon = losses.feature_matching_loss(real_feats.detach(), feats)
    elif pallas_mode(cfg.train.use_pallas) in ("losses", "all"):
        sums = fused.recon_loss_sums(g_imgs, batch)
        recon = (sums[0] + sums[1]) / g_imgs.numel()
    else:
        recon = losses.pixel_reconstruction_loss(g_imgs, batch)
    adv, recon = replica.share(adv), replica.share(recon)
    kl = _kl_share(cfg, replica, losses.kl_divergence(mu, lv, lcfg.kl_reduction))
    g_loss = (lcfg.adversarial_weight * adv + lcfg.reconstruction_weight * recon
              + lcfg.kl_weight * kl_scale * kl)
    return g_loss, adv, recon, kl


def make_train_step(cfg: Config, do_g_update: bool,
                    inject: Optional[Dict[str, object]] = None, do_gp: bool = True,
                    gp_lambda_scale: float = 1.0, replica: Replica = LOCAL) -> Callable:
    """The notebook's two-optimizer step. Returns
    ``step(state, batch, seed) -> (state, metrics)``: ``batch`` is (B, H, W, C) on
    the state's device, ``seed`` an int that decides every random draw; the state
    is updated in place and returned. With ``cfg.train.grad_accum > 1`` the step
    accumulates over microbatches (module docstring).

    ``do_gp=False`` is the lazy-regularization off-step (no penalty, no
    grad-of-grad); ``gp_lambda_scale`` multiplies ``loss.lambda_gp`` and is set by
    the scheduler that skips GP steps (:func:`make_step_variants`), never derived
    from the config here. ``inject``: see the module docstring; ``g_masks`` with
    ``use_pallas="all"`` raises, because the fused kernel draws its own masks.
    ``replica``: this process's place in a data-parallel step (``batch`` and
    ``inject`` are then its rows; module docstring).
    """
    inject = dict(inject or {})
    _refuse_fused_masks(cfg, inject, ("g_masks",))
    _refuse_concat_masks(cfg, inject, ("d_masks_real", "d_masks_fake", "d_masks_interp"))
    if cfg.train.grad_accum > 1:
        return _make_accum_train_step(cfg, do_g_update, inject, do_gp, gp_lambda_scale,
                                      replica)
    dtype = DTYPES[cfg.train.dtype]
    clip = cfg.loss.clip_value

    def step(state: TrainState, batch: torch.Tensor, seed: int) -> Tuple[TrainState, Metrics]:
        gen, critic = state.generator, state.critic
        dev = batch.device
        with precision(dtype):
            # ---- generator forward, ONCE; its graph serves the G half ----------
            with span("step.g_forward", device=dev):
                seeds, draws = _generators(seed, dev)
                with torch.set_grad_enabled(do_g_update):
                    gen_imgs, mu, lv = _gen_forward(cfg, gen, batch, seeds, draws, inject,
                                                    replica)
                gen_sg = gen_imgs.detach()

            # ---- discriminator half --------------------------------------------
            d_params = list(critic.parameters())
            with span("step.d_forward", device=dev):
                d_loss, real_loss, fake_loss, gp = _critic_loss(
                    cfg, critic, batch, gen_sg, draws, inject, do_gp, gp_lambda_scale, replica)
            with span("step.d_backward", device=dev):
                d_grads = _grads(d_loss, d_params)
            with span("step.reduce", device=dev):
                d_grads = _reduce_grads(replica, d_params, d_grads, _split(critic))
            with span("step.d_update", device=dev):
                _apply(state.opt_d, d_params, d_grads)
                if clip is not None:
                    _clamp(d_params, clip)

            # ---- generator half, scored by the UPDATED critic ------------------
            g_metrics = {}
            if do_g_update:
                with span("step.g_half", device=dev):
                    g_loss, adv, recon, kl = _gen_losses(cfg, critic, batch, gen_imgs, mu, lv,
                                                         draws, inject, replica=replica)
                    g_params = list(gen.parameters())
                    g_grads = _grads(g_loss, g_params)
                with span("step.reduce", device=dev):
                    g_grads = _reduce_grads(replica, g_params, g_grads)
                with span("step.g_update", device=dev):
                    _apply(state.opt_g, g_params, g_grads)
                with span("step.ema", device=dev):
                    _ema_update(cfg, state.g_ema, gen)
                g_metrics = dict(zip(G_METRICS, (t.detach() for t in
                                                 (g_loss, adv, recon, kl))))
        state.step += 1
        with span("step.reduce", device=dev):
            d_metrics, g_metrics = _reduce_metrics(replica, {
                "d_loss": d_loss.detach(), "d_real_loss": real_loss.detach(),
                "d_fake_loss": fake_loss.detach(), "gp": gp.detach()}, g_metrics)
        if do_g_update:
            state.g_metrics = g_metrics
        return state, {**d_metrics, **state.g_metrics}

    return step


def _make_accum_train_step(cfg: Config, do_g_update: bool, inject: dict, do_gp: bool,
                           gp_lambda_scale: float, replica: Replica) -> Callable:
    """The two-optimizer step over ``cfg.train.grad_accum`` microbatches (port of
    ``make_accum_train_step``; see the module docstring)."""
    k = int(cfg.train.grad_accum)
    dtype = DTYPES[cfg.train.dtype]
    lcfg = cfg.loss
    clip = lcfg.clip_value
    kl_scale = float(k) if lcfg.kl_reduction == "sum" else 1.0

    def step(state: TrainState, batch: torch.Tensor, seed: int) -> Tuple[TrainState, Metrics]:
        gen, critic = state.generator, state.critic
        dev = batch.device
        micro = _cut(batch, k)
        injects = _micro_injects(inject, ("eps", "alpha"), k, dev)
        mseeds = [micro_seed(seed, j) for j in range(k)]
        d_params = list(critic.parameters())
        with precision(dtype):
            # ---- pass 1: critic gradients summed over the microbatches ---------
            d_sum, d_msum, resume_at = None, None, []
            for x, inj, s in zip(micro, injects, mseeds):
                with span("step.g_forward", device=dev):
                    seeds, draws = _generators(s, dev)
                    with torch.no_grad():
                        gen_sg = _gen_forward(cfg, gen, x, seeds, draws, inj, replica)[0]
                with span("step.d_forward", device=dev):
                    out = _critic_loss(cfg, critic, x, gen_sg, draws, inj, do_gp,
                                       gp_lambda_scale, replica)
                with span("step.d_backward", device=dev):
                    d_sum = _add(d_sum, _grads(out[0], d_params))
                d_msum = _add(d_msum, [t.detach() for t in out])
                # pass 2's critic forwards continue this microbatch's stream here,
                # as the full step's G half continues its D half's
                resume_at.append(draws.get_state())
            with span("step.reduce", device=dev):
                d_grads = _reduce_grads(replica, d_params, [g / k for g in d_sum], _split(critic))
            with span("step.d_update", device=dev):
                _apply(state.opt_d, d_params, d_grads)
                if clip is not None:
                    _clamp(d_params, clip)
            d_loss, real_loss, fake_loss, gp = (t / k for t in d_msum)

            # ---- pass 2: generator gradients against the updated critic --------
            if do_g_update:
                g_params = list(gen.parameters())
                g_sum, g_msum = None, None
                with kept_buffers(gen), span("step.g_half", device=dev):
                    # the recompute keeps pass 1's BN statistics
                    for x, inj, s, at in zip(micro, injects, mseeds, resume_at):
                        seeds, draws = _generators(s, dev)
                        g_imgs, mu, lv = _gen_forward(cfg, gen, x, seeds, draws, inj, replica)
                        draws.set_state(at)
                        out = _gen_losses(cfg, critic, x, g_imgs, mu, lv, draws, inj, kl_scale,
                                          replica)
                        g_sum = _add(g_sum, _grads(out[0], g_params))
                        g_msum = _add(g_msum, [t.detach() for t in out[1:]])
                with span("step.reduce", device=dev):
                    g_grads = _reduce_grads(replica, g_params, [g / k for g in g_sum])
                with span("step.g_update", device=dev):
                    _apply(state.opt_g, g_params, g_grads)
                with span("step.ema", device=dev):
                    _ema_update(cfg, state.g_ema, gen)
                adv, recon, kl_sum = g_msum
                adv, recon = adv / k, recon / k
                kl = kl_sum if lcfg.kl_reduction == "sum" else kl_sum / k
                g_loss = (lcfg.adversarial_weight * adv + lcfg.reconstruction_weight * recon
                          + lcfg.kl_weight * kl)
        state.step += 1
        with span("step.reduce", device=dev):
            d_metrics, g_metrics = _reduce_metrics(
                replica, {"d_loss": d_loss, "d_real_loss": real_loss, "d_fake_loss": fake_loss,
                          "gp": gp},
                dict(zip(G_METRICS, (g_loss, adv, recon, kl))) if do_g_update else {})
        if do_g_update:
            state.g_metrics = g_metrics
        return state, {**d_metrics, **state.g_metrics}

    return step


# ---------------------------------------------------------------------------
# the Larsen Algorithm-1 step
# ---------------------------------------------------------------------------

def _paper_groups(gen: UnsupervisedGeneratorNetwork, critic):
    """The three optimizer groups: encoder + code processor, decoder, critic."""
    enc = list(gen.encoder.parameters()) + list(gen.code_processor.parameters())
    return enc, list(gen.decoder.parameters()), list(critic.parameters())


def _paper_losses(cfg: Config, gen, critic, batch, seeds, draws, inject,
                  kl_scale: float = 1.0, replica: Replica = LOCAL):
    """Algorithm 1's forward over one (micro)batch. Returns ``((enc_l, dec_l,
    dis_l), (l_prior, l_llike, l_gan, bce_real, bce_fake), (x~ record, prior
    decode record))``, the records being :func:`draw_record`'s; the losses are
    this process's shares."""
    lcfg, dev = cfg.loss, batch.device
    with span("step.g_forward", device=dev):
        x_tilde, mu, lv = _gen_forward(cfg, gen, batch, seeds, draws, inject, replica)
        rec_x = draw_record(gen)
        with span("step.prior_decode", device=dev):
            z_p = inject.get("z_p")
            z_p = (replica.draw(mu.shape, lambda s: torch.randn(s, generator=draws, device=dev,
                                                                dtype=mu.dtype), 1)
                   if z_p is None else torch.as_tensor(z_p, device=dev, dtype=mu.dtype))
            with inject_masks(gen, inject.get("g_masks_p")):
                x_p = gen.decode(z_p, train=True, generator=draws, seeds=seeds,
                                 replica=replica)
        rec_p = {k: v for k, v in draw_record(gen).items() if k.startswith("decoder.")}
    with span("step.d_forward", device=dev):
        return _paper_critic_losses(cfg, critic, batch, x_tilde, mu, lv, x_p, draws, inject,
                                    kl_scale, replica) + ((rec_x, rec_p),)


def _paper_critic_losses(cfg: Config, critic, batch, x_tilde, mu, lv, x_p, draws, inject,
                         kl_scale: float, replica: Replica):
    """The critic on the real batch, x~ and x_p, and Algorithm 1's losses:
    ``((enc_l, dec_l, dis_l), (l_prior, l_llike, l_gan, bce_real, bce_fake))``."""
    lcfg = cfg.loss

    def d(x, masks=None, parts=1):
        with inject_masks(critic, masks):
            return critic(x, train=True, return_features=True, generator=draws,
                          replica=replica.concat(parts))

    if cfg.train.critic_batching in CONCAT:
        # one forward scores real, x~ and x_p, so dis_l_shared_dropout has no pair
        # of forwards to act on
        b = batch.shape[0]
        logits, feats = d(torch.cat([batch, x_tilde.to(batch.dtype), x_p.to(batch.dtype)]),
                          parts=3)
        l_real, l_tilde, l_p = logits[:b], logits[b:2 * b], logits[2 * b:]
        f_real, f_tilde = feats[:b], feats[b:2 * b]
    else:
        shared = lcfg.dis_l_shared_dropout
        m_real = inject.get("d_masks_real")
        m_tilde = inject.get("d_masks_tilde", m_real if shared else None)
        rewind = draws.get_state() if shared else None
        l_real, f_real = d(batch, m_real)
        if rewind is not None:      # x~ draws the real forward's masks again
            draws.set_state(rewind)
        l_tilde, f_tilde = d(x_tilde, m_tilde)
        l_p, _ = d(x_p, inject.get("d_masks_prior"))

    share = replica.share
    l_prior = _kl_share(cfg, replica, losses.kl_divergence(mu, lv, lcfg.kl_reduction))
    l_llike = share(losses.feature_matching_loss(f_real, f_tilde))
    bce_real = share(losses.bce_with_logits(l_real, 1.0))
    bce_fake = share(losses.bce_with_logits(l_tilde, 0.0) + losses.bce_with_logits(l_p, 0.0))
    l_gan = bce_real + bce_fake
    enc_l = lcfg.kl_weight * kl_scale * l_prior + lcfg.reconstruction_weight * l_llike
    dec_l = (cfg.optim.gamma * lcfg.reconstruction_weight * l_llike
             - lcfg.adversarial_weight * l_gan)
    dis_l = lcfg.adversarial_weight * l_gan
    return (enc_l, dec_l, dis_l), (l_prior, l_llike, l_gan, bce_real, bce_fake)


# the span of each group's gradient pass, in the order of ``_paper_groups``
GRAD_SPANS = ("step.grad_enc", "step.grad_dec", "step.grad_dis")


def _paper_grads(groups, group_losses):
    """Each group's gradient of its own loss, over one graph, each pass in its
    span."""
    last, dev = len(groups) - 1, group_losses[0].device
    out = []
    for i, (name, params, loss) in enumerate(zip(GRAD_SPANS, groups, group_losses)):
        with span(name, device=dev):
            out.append(_grads(loss, params, retain_graph=i < last))
    return out


def _paper_update(cfg: Config, state: TrainState, groups, grads,
                  replica: Replica = LOCAL) -> None:
    """All three optimizers after the losses (one ``opt_g`` holds the encoder
    and decoder groups: see ``train.state``), the clamp for WGAN configs only
    (the notebook's WGAN device; Algorithm 1 has none, and the default
    ``clip_value`` would cripple a BCE critic), then the EMA. Each optimizer's
    gradients are summed over the processes first."""
    (enc, dec, dis), (g_enc, g_dec, g_dis) = groups, grads
    dev = dis[0].device
    with span("step.reduce", device=dev):
        g_gen = _reduce_grads(replica, enc + dec, list(g_enc) + list(g_dec))
        g_dis = _reduce_grads(replica, dis, g_dis, _split(state.critic))
    with span("step.d_update", device=dev):
        _apply(state.opt_g, enc + dec, g_gen)
        _apply(state.opt_d, dis, g_dis)
        if cfg.loss.clip_value is not None and cfg.loss.adversarial == "wgan":
            _clamp(dis, cfg.loss.clip_value)
    with span("step.ema", device=dev):
        _ema_update(cfg, state.g_ema, state.generator)


def _paper_metrics(state: TrainState, replica: Replica, g_loss, d_loss, l_gan, l_llike,
                   l_prior, bce_real, bce_fake) -> Metrics:
    with span("step.reduce", device=d_loss.device):
        d_metrics, state.g_metrics = _reduce_metrics(
            replica, {"d_loss": d_loss.detach(), "d_real_loss": bce_real.detach(),
                      "d_fake_loss": bce_fake.detach()},
            dict(zip(G_METRICS, (t.detach() for t in (g_loss, l_gan, l_llike, l_prior)))))
    return {**d_metrics, "gp": torch.zeros((), device=d_loss.device), **state.g_metrics}


def make_paper_train_step(cfg: Config, inject: Optional[Dict[str, object]] = None,
                          replica: Replica = LOCAL) -> Callable:
    """Larsen et al. Algorithm 1 (three optimizers; module docstring). Returns
    ``step(state, batch, seed) -> (state, metrics)`` like :func:`make_train_step`.
    Metrics: ``d_loss`` = dis_l, ``d_real_loss`` = the BCE on the real batch,
    ``d_fake_loss`` = the BCE on x~ plus the one on x_p, ``gp`` = 0, ``g_loss`` =
    enc_l + dec_l, ``adv_loss`` = L_GAN, ``recon_loss`` = L_llike, ``kl`` =
    L_prior. After a call, ``step.draws`` holds the :func:`draw_record` of its x~
    forward (``"x"``) and prior decode (``"p"``); :func:`paper_draws` rebuilds
    them as an ``inject``. ``g_masks`` / ``g_masks_p`` with ``use_pallas="all"``
    raise, as in :func:`make_train_step`; ``replica`` as there."""
    if not cfg.generator.is_vae:
        raise ValueError("the Larsen Algorithm-1 step requires a VAE code distribution "
                         "(generator.is_vae=True); use make_train_step for plain-AE "
                         "configurations")
    inject = dict(inject or {})
    _refuse_fused_masks(cfg, inject, ("g_masks", "g_masks_p"))
    _refuse_concat_masks(cfg, inject, ("d_masks_real", "d_masks_tilde", "d_masks_prior"))
    if cfg.train.grad_accum > 1:
        return _make_paper_accum_step(cfg, inject, replica)
    dtype = DTYPES[cfg.train.dtype]

    def step(state: TrainState, batch: torch.Tensor, seed: int) -> Tuple[TrainState, Metrics]:
        seeds, draws = _generators(seed, batch.device)
        groups = _paper_groups(state.generator, state.critic)
        with precision(dtype):
            group_losses, aux, records = _paper_losses(cfg, state.generator, state.critic,
                                                       batch, seeds, draws, inject,
                                                       replica=replica)
            with span("step.d_backward", device=batch.device):
                grads = _paper_grads(groups, group_losses)
            _paper_update(cfg, state, groups, grads, replica)
        step.draws = dict(zip(("x", "p"), records))
        enc_l, dec_l, dis_l = group_losses
        l_prior, l_llike, l_gan, bce_real, bce_fake = aux
        state.step += 1
        return state, _paper_metrics(state, replica, enc_l + dec_l, dis_l, l_gan, l_llike,
                                     l_prior, bce_real, bce_fake)

    step.draws = None
    return step


def _make_paper_accum_step(cfg: Config, inject: dict, replica: Replica) -> Callable:
    """The Algorithm-1 step over ``cfg.train.grad_accum`` microbatches (port of
    ``_make_paper_accum_step``): one pass, each group's gradients summed, all
    three optimizers after the last microbatch."""
    k = int(cfg.train.grad_accum)
    dtype = DTYPES[cfg.train.dtype]
    lcfg = cfg.loss
    kl_scale = float(k) if lcfg.kl_reduction == "sum" else 1.0

    def step(state: TrainState, batch: torch.Tensor, seed: int) -> Tuple[TrainState, Metrics]:
        micro = _cut(batch, k)
        injects = _micro_injects(inject, ("eps", "z_p"), k, batch.device)
        groups = _paper_groups(state.generator, state.critic)
        sums, msum = [None] * 3, None
        with precision(dtype):
            for j, (x, inj) in enumerate(zip(micro, injects)):
                seeds, draws = _generators(micro_seed(seed, j), batch.device)
                group_losses, aux, _ = _paper_losses(cfg, state.generator, state.critic, x,
                                                     seeds, draws, inj, kl_scale, replica)
                with span("step.d_backward", device=batch.device):
                    for i, g in enumerate(_paper_grads(groups, group_losses)):
                        sums[i] = _add(sums[i], g)
                enc_l, dec_l, dis_l = group_losses
                msum = _add(msum, [t.detach() for t in (enc_l + dec_l, dis_l, *aux)])
            _paper_update(cfg, state, groups, [[g / k for g in s] for s in sums], replica)
        g_loss, d_loss, l_prior, l_llike, l_gan, bce_real, bce_fake = (t / k for t in msum)
        if lcfg.kl_reduction == "sum":
            l_prior = l_prior * k          # the full batch's KL is the sum over microbatches
        state.step += 1
        return state, _paper_metrics(state, replica, g_loss, d_loss, l_gan, l_llike, l_prior,
                                     bce_real, bce_fake)

    return step
