"""The port's critic against the JAX package's, on weights carried across with
``from_jax_variables``: spectral norm, the critic's logits and each
``return_features`` tap in eval and train mode (with the critic's Dropout2d
masks injected into both), the state a train forward advances (BN running
statistics, spectral u and v), and the input gradient the gradient penalty
takes. Also the model-building rules (which nets fuse) and the float32
precision of the backward convolutions.

Whole-network tolerance is 1e-4 of each output's scale: oneDNN (torch) and
XLA:CPU sum the convolutions in different orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaegan_tpu import interop as jinterop
from vaegan_tpu.config import preset as jpreset
from vaegan_tpu.ops.spectral_norm import spectral_normalize as jspectral_normalize
from vaegan_tpu.train.state import build_models as jbuild_models
import vaegan_tpu_torch as vt
from vaegan_tpu_torch.interop import from_jax_variables
from vaegan_tpu_torch.models import Dropout, ResBlockDiscriminator, critic_pool_shape, layers
from vaegan_tpu_torch.ops.spectral_norm import spectral_normalize

# the suite runs files in parallel workers; one intra-op thread each keeps
# torch from taking every core from the other workers
torch.set_num_threads(1)

SIZE, BATCH = 32, 2


def tol(a):
    return dict(rtol=0, atol=1e-4 * max(1.0, float(np.abs(np.asarray(a)).max())))


@pytest.mark.parametrize("update", [False, True])
def test_spectral_normalize_matches_jax(update):
    """W / sigma, the power-iterated (u, v), and the gradient of W / sigma in W
    (sigma's own dependence on W included), on an HWIO kernel and its OIHW copy."""
    rng = np.random.default_rng(0)
    k = rng.normal(size=(3, 3, 4, 6)).astype(np.float32)
    u = rng.normal(size=6).astype(np.float32)
    v = rng.normal(size=36).astype(np.float32)
    u, v = u / np.linalg.norm(u), v / np.linalg.norm(v)
    r = rng.normal(size=k.shape).astype(np.float32)

    def jf(k):
        kn, nu, nv = jspectral_normalize(k, jnp.asarray(u), jnp.asarray(v), update=update)
        return jnp.sum(kn * r), (kn, nu, nv)

    (_, (jkn, ju, jv)), jg = jax.value_and_grad(jf, has_aux=True)(jnp.asarray(k))
    w = torch.from_numpy(k.transpose(3, 2, 0, 1).copy()).requires_grad_(True)
    wn, pu, pv = spectral_normalize(w, torch.from_numpy(u), torch.from_numpy(v), update=update)
    (g,) = torch.autograd.grad((wn * torch.from_numpy(r.transpose(3, 2, 0, 1).copy())).sum(), w)
    np.testing.assert_allclose(wn.detach().numpy(), np.asarray(jkn).transpose(3, 2, 0, 1),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pu.numpy(), np.asarray(ju), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg).transpose(3, 2, 0, 1),
                               rtol=1e-4, atol=1e-5)


DISC = {
    "pre-activation": dict(num_features_conv1=8, num_blocks=(2, 1), num_strides_res=(1, 2),
                           num_features_res=(8, 16), linear_widths=(16, 8)),
    "standard": dict(num_stride_conv1=2, num_features_conv1=4, num_blocks=(1, 1),
                     num_strides_res=(2, 1), num_features_res=(8, 12), linear_widths=(8,),
                     res_mode="standard", pool_size=2),
}


def pair(name, lambda_gp=10.0, use_pallas="off", tap="res_out"):
    """(JAX critic, its variables with perturbed running stats, port critic)."""
    jcfg = jpreset("notebook")
    jcfg = jcfg.replace(
        discriminator=jcfg.discriminator.replace(feature_tap=tap, **DISC[name]),
        data=jcfg.data.replace(image_size=SIZE),
        loss=jcfg.loss.replace(lambda_gp=lambda_gp),
        train=jcfg.train.replace(use_pallas=use_pallas))
    _, jdisc = jbuild_models(jcfg)
    k = jax.random.key(0)
    v = jax.jit(lambda: jdisc.init({"params": k, "dropout": k},
                                   jnp.zeros((1, SIZE, SIZE, 1)), train=False))()
    rng = np.random.default_rng(1)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (np.asarray(a) + (0.3 * rng.standard_normal(a.shape) if p[-1].key == "mean"
                                       else 0.5 * rng.standard_normal(a.shape) ** 2)
                      ).astype(np.float32), v["batch_stats"])
    v = {**v, "batch_stats": stats}
    cfg = vt.Config.from_dict(jcfg.to_dict())
    _, critic = vt.build_models(cfg, device="cpu")
    critic.load_state_dict(from_jax_variables(v, critic.pool_shape), strict=True)
    return jdisc, v, critic


def images(seed=2):
    return np.random.default_rng(seed).normal(size=(BATCH, SIZE, SIZE, 1)).astype(np.float32)


def test_pool_shape_matches_jax_interop():
    for name in DISC:
        jcfg = jpreset("notebook").replace(
            discriminator=jpreset("notebook").discriminator.replace(**DISC[name]),
            data=jpreset("notebook").data.replace(image_size=SIZE))
        cfg = vt.Config.from_dict(jcfg.to_dict())
        assert critic_pool_shape(cfg.discriminator, SIZE) == jinterop.critic_pool_shape(jcfg)
    cfg = vt.preset("notebook")
    assert critic_pool_shape(cfg.discriminator, 256) == (512, 16, 16)


@pytest.mark.parametrize("tap", ["res_out", "pool", "fc1"])
@pytest.mark.parametrize("name", sorted(DISC))
def test_eval_logits_and_features_match_jax(name, tap):
    if tap == "fc1" and name == "standard":
        tap = "pool"
    jdisc, v, critic = pair(name, tap=tap)
    x = images()
    jl, jf = jax.jit(lambda v, x: jdisc.apply(v, x, train=False, return_features=True))(v, x)
    with torch.no_grad():
        logits, feats = critic(torch.from_numpy(x), train=False, return_features=True)
    assert tuple(logits.shape) == (BATCH, 1) and feats.shape == jf.shape
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), **tol(jl))
    np.testing.assert_allclose(feats.numpy(), np.asarray(jf), **tol(jf))


def _masks(critic, seed=3):
    rng = np.random.default_rng(seed)
    return {f"{n}.dropout": torch.from_numpy(rng.random((BATCH, m.conv1.weight_orig.shape[0], 1, 1))
                                             >= 0.5)
            for n, m in critic.named_modules() if isinstance(m, ResBlockDiscriminator)}


@pytest.mark.parametrize("name", sorted(DISC))
def test_train_forward_state_and_input_gradient_match_jax(name):
    """A train forward with injected Dropout2d masks: logits, the updated BN
    statistics and spectral (u, v), and d sum(logits) / d x (what the gradient
    penalty differentiates once more)."""
    jdisc, v, critic = pair(name)
    x = images()
    masks = _masks(critic)
    jm = jax.tree.map(jnp.asarray, jinterop.reference_dropout_masks_to_collection(
        [(k, m.numpy().astype(np.float32)) for k, m in masks.items()], "discriminator"))

    def jf(x):
        out, upd = jdisc.apply({**v, "masks": jm}, x, train=True,
                               mutable=["batch_stats", "spectral"])
        return jnp.sum(out), (out, upd)

    (_, (jl, upd)), jgx = jax.jit(jax.value_and_grad(jf, has_aux=True))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    with layers.inject_masks(critic, masks):
        logits = critic(xt, train=True)
    (gx,) = torch.autograd.grad(logits.sum(), xt)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl), **tol(jl))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), **tol(jgx))
    want = from_jax_variables(upd, critic.pool_shape)
    sd = critic.state_dict()
    for k, val in want.items():
        np.testing.assert_allclose(sd[k].numpy(), val.numpy(), rtol=1e-4, atol=1e-5, err_msg=k)


def test_fused_critic_matches_unfused_without_gp():
    """With no penalty configured the critic fuses its BN + LeakyReLU chains
    (p = 0): eval and train logits equal the unfused critic's."""
    _, v, plain = pair("pre-activation", lambda_gp=0.0, use_pallas="off")
    _, _, fusedc = pair("pre-activation", lambda_gp=0.0, use_pallas="all")
    assert fusedc.use_pallas and not plain.use_pallas
    x = torch.from_numpy(images())
    masks = _masks(plain)
    for train in (False, True):
        with torch.no_grad(), layers.inject_masks(plain, masks), \
                layers.inject_masks(fusedc, masks):
            a, b = plain(x, train=train), fusedc(x, train=train)
        np.testing.assert_allclose(b.numpy(), a.numpy(), **tol(a.numpy()))


def test_build_models_fuses_the_critic_only_without_gp():
    cfg = vt.Config.from_dict(jpreset("notebook").replace(
        discriminator=jpreset("notebook").discriminator.replace(**DISC["standard"]),
        data=jpreset("notebook").data.replace(image_size=SIZE)).to_dict())
    for mode, gp, want_gen, want_critic, want_reparam in (
            ("all", 10.0, True, False, True), ("all", 0.0, True, True, True),
            ("losses", 10.0, False, False, True), ("off", 0.0, False, False, False)):
        c = cfg.replace(train=cfg.train.replace(use_pallas=mode),
                        loss=cfg.loss.replace(lambda_gp=gp))
        gen, critic = vt.build_models(c, device="cpu")
        blocks = [m for m in gen.modules() if isinstance(m, vt.models.ResBlockVAE)]
        assert all(b.use_pallas == want_gen for b in blocks)
        assert critic.use_pallas == want_critic
        assert all(b.use_pallas == want_critic for b in critic.modules()
                   if isinstance(b, ResBlockDiscriminator))
        assert gen.code_processor.use_pallas == want_reparam
    a = vt.build_models(cfg, device="cpu", seed=3)[0].state_dict()
    b = vt.build_generator(cfg, device="cpu", seed=3).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_mask_injection_rejects_unknown_paths():
    _, _, critic = pair("standard")
    with pytest.raises(KeyError):
        with layers.inject_masks(critic, {"res_layers.9.0.dropout": torch.ones(1)}):
            pass
    masks = _masks(critic)
    with layers.inject_masks(critic, masks):
        assert all(m.mask is not None for m in critic.modules() if isinstance(m, Dropout))
    assert all(m.mask is None for m in critic.modules() if isinstance(m, Dropout))


def test_step_backward_convolutions_run_in_ieee_float32(monkeypatch):
    """With TF32 allowed process-wide, every convolution backward of a float32
    train step, the penalty's double backward included, runs with cuDNN's TF32
    off; the flag is restored after the step. A spy node after each conv records
    the flag when autograd runs its backward, and places itself again in the
    graph the backward builds, so the double backward is recorded too; the
    input gradients and the penalty's weight gradients of ``Conv2D`` (``ops.conv``)
    record it where they are computed."""
    from vaegan_tpu_torch.ops import conv as conv_ops

    seen, computed = [], []

    class Spy(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            seen.append(torch.backends.cudnn.allow_tf32)
            return Spy.apply(g)

    conv2d, conv_backward = layers.F.conv2d, conv_ops._conv_backward

    def spy_backward(*a):
        computed.append(torch.backends.cudnn.allow_tf32)
        return conv_backward(*a)

    monkeypatch.setattr(layers.F, "conv2d", lambda *a, **k: Spy.apply(conv2d(*a, **k)))
    monkeypatch.setattr(conv_ops, "_conv_backward", spy_backward)
    cfg = vt.Config.from_dict(jpreset("notebook").replace(
        generator=jpreset("notebook").generator.replace(depth=1, feature_size=4),
        discriminator=jpreset("notebook").discriminator.replace(**DISC["standard"]),
        data=jpreset("notebook").data.replace(image_size=SIZE)).to_dict())
    state = vt.create_train_state(cfg, device="cpu")
    n_critic_convs = sum(1 for m in state.critic.modules() if isinstance(m, layers.Conv2D))
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        vt.make_train_step(cfg, True)(state, torch.rand(BATCH, SIZE, SIZE, 1), 0)
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    # each critic conv: the input gradients of the penalty's forward (inner),
    # of the real, fake and interpolate forwards (outer) and of the G half's,
    # and the penalty's weight gradient; the weight gradients of three forwards
    assert len(computed) >= 5 * n_critic_convs
    assert len(seen) >= 3 * n_critic_convs
    seen += computed
    assert not any(seen)
