"""The port's generator against the JAX generator on the same converted weights
and the same inputs: eval-mode forward (fused and unfused BN), encode, decode,
interpolate, the non-VAE variant, and the train-mode forward with injected noise.

Whole-network tolerance is 1e-4 abs/rel: oneDNN (torch) and XLA:CPU sum the
convolutions in different orders.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaegan_tpu import inference as jinference
from vaegan_tpu.config import preset as jpreset
from vaegan_tpu.train.state import TrainState, build_models as jbuild_models
import vaegan_tpu_torch as vt
from vaegan_tpu_torch.models import BatchNorm, Dropout
from vaegan_tpu_torch.ops import fused

TOL = dict(rtol=1e-4, atol=1e-4)
SIZE = 16


def configs(use_pallas="all", dropout_prob=0.5, **gen):
    """(JAX config, port config) of a small notebook-style generator."""
    jcfg = jpreset("notebook")
    gkw = dict(depth=2, length=1, feature_size=4)
    gkw.update(gen)
    jcfg = jcfg.replace(
        generator=jcfg.generator.replace(dropout_prob=dropout_prob, **gkw),
        data=jcfg.data.replace(image_size=SIZE),
        train=jcfg.train.replace(use_pallas=use_pallas))
    return jcfg, vt.Config.from_dict(jcfg.to_dict())


@functools.lru_cache(maxsize=None)
def _jax_init(gen_items):
    """Generator variables with perturbed running stats (so eval BN is tested)."""
    jcfg, _ = configs("off", **dict(gen_items))
    gen, _ = jbuild_models(jcfg)
    k = jax.random.key(0)
    v = jax.jit(lambda: gen.init({"params": k, "dropout": k, "noise": k},
                                 jnp.zeros((1, SIZE, SIZE, 1)), train=False))()
    rng = np.random.default_rng(1)

    def perturb(path, a):
        z = rng.standard_normal(a.shape)
        bump = 0.3 * z if path[-1].key == "mean" else 0.5 * z ** 2
        return (np.asarray(a) + bump).astype(np.float32)

    stats = jax.tree_util.tree_map_with_path(perturb, v["batch_stats"])
    return {"params": v["params"], "batch_stats": stats}


def setup(use_pallas="all", **gen):
    jcfg, cfg = configs(use_pallas, **gen)
    v = _jax_init(tuple(sorted(gen.items())))
    jgen, _ = jbuild_models(jcfg)
    port = vt.build_generator(cfg, device="cpu")
    port.load_state_dict(vt.from_jax_variables(v), strict=True)
    return jcfg, cfg, jgen, v, port


def images(n=2, seed=2):
    return np.random.default_rng(seed).normal(size=(n, SIZE, SIZE, 1)).astype(np.float32)


@pytest.mark.parametrize("length", [1, 2])
@pytest.mark.parametrize("res_mode", ["pre-activation", "standard"])
@pytest.mark.parametrize("use_pallas", ["off", "all"])
def test_eval_forward_matches_jax(use_pallas, res_mode, length):
    _, _, jgen, v, port = setup(use_pallas, res_mode=res_mode, length=length)
    x = images()
    want = jax.jit(lambda v, x: jgen.apply(v, x, train=False))(v, x)
    with torch.no_grad():
        got = port(torch.from_numpy(x), train=False)
    for g, w, what in zip(got, want, ("recon", "mu", "log_var")):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=what, **TOL)


def test_encode_decode_match_jax():
    _, _, jgen, v, port = setup("all")
    x = images()
    z = np.random.default_rng(3).normal(size=(2, 4, 4, 16)).astype(np.float32)
    enc = jgen.apply(v, x, train=False, method=jgen.encode)
    dec = jgen.apply(v, z, train=False, method=jgen.decode)
    with torch.no_grad():
        np.testing.assert_allclose(port.encode(torch.from_numpy(x)).numpy(), np.asarray(enc), **TOL)
        np.testing.assert_allclose(port.decode(torch.from_numpy(z)).numpy(), np.asarray(dec), **TOL)


def test_interpolate_matches_jax():
    jcfg, cfg, _, v, port = setup("all")
    x1, x2 = images(2, seed=4), images(2, seed=5)
    jstate = TrainState(step=0, g_params=v["params"], d_params={}, g_stats=v["batch_stats"],
                        d_stats={}, d_spectral={}, opt_g={}, opt_d={}, g_metrics={})
    want = jinference.interpolate(jcfg, jstate, jnp.asarray(x1), jnp.asarray(x2), steps=5)
    got = vt.interpolate(cfg, vt.GeneratorState(generator=port), x1, x2, steps=5)
    assert tuple(got.shape) == (5, 2, SIZE, SIZE, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_non_vae_generator_matches_jax():
    _, _, jgen, v, port = setup("all", is_vae=False)
    x = images()
    assert port.code_processor is None
    want = jgen.apply(v, x, train=False)
    enc = jgen.apply(v, x, train=False, method=jgen.encode)
    with torch.no_grad():
        np.testing.assert_allclose(port(torch.from_numpy(x), train=False).numpy(),
                                   np.asarray(want), **TOL)
        np.testing.assert_allclose(port.encode(torch.from_numpy(x)).numpy(), np.asarray(enc), **TOL)


def test_train_forward_with_injected_eps_matches_jax():
    """Train mode, unfused, dropout 0 and injected eps: batch-statistics
    normalization and the unbiased running-stat update, against JAX's."""
    v = _jax_init(())
    jcfg0, cfg0 = configs("off", dropout_prob=0.0)
    jgen, _ = jbuild_models(jcfg0)
    port = vt.build_generator(cfg0, device="cpu")
    port.load_state_dict(vt.from_jax_variables(v), strict=True)
    x = images(4)
    eps = np.random.default_rng(6).normal(size=(4, 4, 4, 16)).astype(np.float32)
    (want, upd) = jgen.apply(v, x, train=True, eps=eps, mutable=["batch_stats"])
    got = port(torch.from_numpy(x), train=True, eps=torch.from_numpy(eps))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), **TOL)
    new = vt.from_jax_variables({"batch_stats": upd["batch_stats"]})
    sd = port.state_dict()
    for k, val in new.items():
        np.testing.assert_allclose(sd[k].numpy(), val.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


def test_train_mode_needs_eps_and_the_unfused_path():
    """Train mode draws its own noise on both paths now: the fused generator in
    the ``reparam_kl`` kernel (its plain version here) from a seed drawn from
    ``seeds``, the unfused one from the device ``generator``; the same draws give
    the same outputs, and the fused draws replay as the kernel's plain noise."""
    x = torch.from_numpy(images())
    port = setup("all", dropout_prob=0.0)[-1]    # p = 0: the seeds feed the noise only
    a = port(x, train=True, seeds=torch.Generator().manual_seed(1))
    seed, shape = port.code_processor.last_draw
    b = port(x, train=True, seeds=torch.Generator().manual_seed(1))
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    z_mu = port(x, train=True, eps=torch.zeros(shape[0], shape[2], shape[3], shape[1]),
                seeds=torch.Generator().manual_seed(1))
    eps = fused.reparam_noise(shape, seed, "cpu").permute(0, 2, 3, 1)
    again = port(x, train=True, eps=eps, seeds=torch.Generator().manual_seed(1))
    np.testing.assert_allclose(again[0].detach().numpy(), a[0].detach().numpy(), **TOL)
    assert not torch.allclose(z_mu[0], a[0])
    port = setup("off")[-1]
    c = port(x, train=True, generator=torch.Generator().manual_seed(2))
    d = port(x, train=True, generator=torch.Generator().manual_seed(2))
    assert all(torch.equal(p, q) for p, q in zip(c, d)) and torch.isfinite(c[0]).all()


def test_dropout_elementwise_and_channelwise():
    g = torch.Generator().manual_seed(0)
    x = torch.ones(4, 8, 16, 16)
    y = Dropout(0.5)(x, train=True, generator=g)
    assert 0.45 <= float((y != 0).float().mean()) <= 0.55
    assert set(torch.unique(y).tolist()) <= {0.0, 2.0}
    yc = Dropout(0.5, channelwise=True)(x, train=True, generator=g)
    per_map = (yc != 0).float().mean(dim=(2, 3))
    assert set(torch.unique(per_map).tolist()) <= {0.0, 1.0}     # whole maps dropped
    assert torch.equal(Dropout(0.5)(x, train=False), x)


def test_batchnorm_eval_fused_equals_unfused():
    bn = BatchNorm(6)
    with torch.no_grad():
        bn.running_mean.uniform_(-0.5, 0.5)
        bn.running_var.uniform_(0.5, 2.0)
        bn.weight.uniform_(0.5, 1.5)
    x = torch.randn(2, 10, 10, 6).permute(0, 3, 1, 2)
    fused = bn(x, train=False, fuse=(0.01, 0.5))       # eval: p is not applied
    plain = bn(x, train=False)
    plain = torch.where(plain > 0, plain, plain * 0.01)
    np.testing.assert_allclose(fused.detach().numpy(), plain.detach().numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype,want_tf32", [(torch.float32, False), (torch.bfloat16, True)])
def test_conv_precision_is_the_layers_not_the_process_default(monkeypatch, dtype, want_tf32):
    """A float32 layer convolves with cuDNN's TF32 switched off, whatever the
    process-wide flag, and restores the flag after; a bfloat16 layer leaves it."""
    from vaegan_tpu_torch.models import layers

    seen, conv2d = [], layers.F.conv2d

    def spy(x, w, b, **kw):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv2d(x, w, b, **kw)

    monkeypatch.setattr(layers.F, "conv2d", spy)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        conv = layers.Conv2D(2, 3, dtype=dtype)
        conv(torch.randn(1, 2, 5, 5))
        assert seen == [want_tf32] and torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = prev
