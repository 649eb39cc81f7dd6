"""The port's losses and optimizers against the JAX package's on the same
numpy inputs: the pixel, KL, BCE, WGAN and feature-matching losses, the
gradient penalty (value, and its grad-of-grad in a critic's parameters), and
RMSprop / Adam with coupled weight decay and the lr_g / lr_d split over a few
updates. Tolerance 1e-5 relative unless stated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaegan_tpu import losses as jlosses
from vaegan_tpu.config import OptimConfig as JOptimConfig
from vaegan_tpu.train.optim import build_optimizer as jbuild_optimizer
from vaegan_tpu_torch import losses
from vaegan_tpu_torch.config import OptimConfig
from vaegan_tpu_torch.train.optim import build_optimizer, role_lr

# the suite runs files in parallel workers; one intra-op thread each keeps
# torch from taking every core from the other workers
torch.set_num_threads(1)

RNG = np.random.default_rng(0)
A = RNG.normal(size=(3, 8, 8, 2)).astype(np.float32)
B = RNG.normal(size=(3, 8, 8, 2)).astype(np.float32)
LOGITS = (RNG.normal(size=(5, 1)) * 30).astype(np.float32)   # saturating BCE included


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("name", ["l1_loss", "mse_loss", "pixel_reconstruction_loss",
                                  "feature_matching_loss"])
def test_pair_losses(name):
    np.testing.assert_allclose(float(getattr(losses, name)(t(A), t(B))),
                               float(getattr(jlosses, name)(A, B)), rtol=1e-5)


@pytest.mark.parametrize("reduction", ["sum", "mean"])
def test_kl_divergence(reduction):
    lv = (B * 0.5).astype(np.float32)
    np.testing.assert_allclose(float(losses.kl_divergence(t(A), t(lv), reduction)),
                               float(jlosses.kl_divergence(A, lv, reduction)), rtol=1e-5)
    with pytest.raises(ValueError):
        losses.kl_divergence(t(A), t(lv), "max")


@pytest.mark.parametrize("target", [0.0, 1.0])
def test_bce_with_logits_is_stable_and_matches(target):
    got = losses.bce_with_logits(t(LOGITS), target)
    np.testing.assert_allclose(float(got), float(jlosses.bce_with_logits(LOGITS, target)),
                               rtol=1e-5)
    ref = torch.nn.functional.binary_cross_entropy_with_logits(
        t(LOGITS), torch.full(LOGITS.shape, target))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


def test_wgan_losses():
    r, f = LOGITS, LOGITS[::-1].copy()
    got = losses.wgan_critic_loss(t(r), t(f)) + (losses.wgan_generator_loss(t(f)),)
    want = jlosses.wgan_critic_loss(r, f) + (jlosses.wgan_generator_loss(f),)
    np.testing.assert_allclose([float(g) for g in got], [float(w) for w in want], rtol=1e-6)


def test_gradient_penalty_and_its_grad_of_grad():
    """A small nonlinear critic D(x) = sum(tanh(x W) V) per sample, the same in
    both packages: the penalty at per-sample alphas, and its gradient in (W, V),
    which runs through the input gradient (create_graph=True). 1e-5 relative."""
    w = (RNG.normal(size=(2, 4)) * 0.7).astype(np.float32)
    v = RNG.normal(size=(4,)).astype(np.float32)
    alpha = RNG.random(3).astype(np.float32)

    def jcritic(params, x):
        return jnp.sum(jnp.tanh(x @ params[0]) @ params[1], axis=(1, 2))[:, None]

    def jgp(params):
        return jlosses.gradient_penalty(lambda x: jcritic(params, x), jnp.asarray(A),
                                        jnp.asarray(B), None, alpha=alpha)[0]

    jval, (jgw, jgv) = jax.value_and_grad(jgp)((jnp.asarray(w), jnp.asarray(v)))
    tw, tv = t(w).requires_grad_(True), t(v).requires_grad_(True)
    gp = losses.gradient_penalty(
        lambda x: (torch.tanh(x @ tw) @ tv).sum(dim=(1, 2))[:, None], t(A), t(B), t(alpha))
    gw, gv = torch.autograd.grad(gp, (tw, tv))
    np.testing.assert_allclose(float(gp.detach()), float(jval), rtol=1e-5)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jgw), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(gv.numpy(), np.asarray(jgv), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("optimizer,lr_g,lr_d", [("rmsprop", None, None),
                                                 ("rmsprop", 1e-4, 3e-3),
                                                 ("adam", None, 2e-4)])
def test_optimizers_match_jax_over_three_updates(optimizer, lr_g, lr_d):
    """The port's torch.optim optimizer against the JAX package's optax chain on
    the same parameters and gradients, per role, after each of three updates
    (RMSprop: coupled L2, eps outside the root; Adam: coupled decay).
    1e-6 absolute + 1e-5 relative."""
    kw = dict(optimizer=optimizer, lr=3e-4, lr_g=lr_g, lr_d=lr_d, weight_decay=1e-3)
    jcfg, cfg = JOptimConfig(**kw), OptimConfig(**kw)
    for role in ("g", "d"):
        p0 = RNG.normal(size=(4, 3)).astype(np.float32)
        grads = [RNG.normal(size=p0.shape).astype(np.float32) * s for s in (1.0, 0.1, 3.0)]
        tx = jbuild_optimizer(jcfg, role)
        jp, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
        tp = torch.nn.Parameter(t(p0))
        opt = build_optimizer(cfg, [tp], role)
        assert opt.param_groups[0]["lr"] == role_lr(cfg, role)
        for g in grads:
            upd, state = tx.update(jnp.asarray(g), state, jp)
            jp = jp + upd
            tp.grad = t(g)
            opt.step()
            np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-5, atol=1e-6)
