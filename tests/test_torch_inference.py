"""The port's inference and serving entry points against the JAX package's on
the same weights: reconstruct + MSE, evaluate_mse, sample, the mean-predictor
floor, the serving bundle, and the CUDA-by-default device rule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaegan_tpu import inference as jinference
from vaegan_tpu.config import preset as jpreset
from vaegan_tpu.train.state import create_train_state
import vaegan_tpu_torch as vt
from vaegan_tpu_torch import serving

# the suite runs files in parallel workers; one intra-op thread each keeps
# torch from taking every core from the other workers
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
SIZE = 16


@pytest.fixture(scope="module")
def pair():
    """(JAX cfg, JAX state, port cfg, port state) sharing one generator's weights,
    with perturbed running stats so eval BN is exercised."""
    jcfg = jpreset("vae_96")
    jcfg = jcfg.replace(generator=jcfg.generator.replace(depth=2, feature_size=4),
                        data=jcfg.data.replace(image_size=SIZE),
                        train=jcfg.train.replace(use_pallas="all", ema_decay=0.999))
    jstate = create_train_state(jcfg, jax.random.key(0))
    rng = np.random.default_rng(0)
    g_stats = jax.tree.map(
        lambda a: (np.asarray(a) + 0.4 * rng.standard_normal(a.shape) ** 2).astype(np.float32),
        jstate.g_stats)
    jstate = jstate.replace(g_stats=g_stats)
    cfg = vt.Config.from_dict(jcfg.to_dict())
    state = vt.create_generator_state(cfg, device="cpu")
    state.generator.load_state_dict(
        vt.from_jax_variables({"params": jstate.g_params, "batch_stats": g_stats}), strict=True)
    return jcfg, jstate, cfg, state


def batch(n=3, seed=1):
    return np.random.default_rng(seed).normal(size=(n, SIZE, SIZE, 1)).astype(np.float32)


def test_reconstruct_matches_jax(pair):
    jcfg, jstate, cfg, state = pair
    x = batch()
    jrec, jmse = jinference.reconstruct(jcfg, jstate, jnp.asarray(x))
    rec, mse = vt.reconstruct(cfg, state, x)
    assert mse.dtype == torch.float32 and mse.dim() == 0
    np.testing.assert_allclose(rec.numpy(), np.asarray(jrec), **TOL)
    np.testing.assert_allclose(float(mse), float(jmse), rtol=1e-5)


def test_evaluate_mse_matches_jax_and_rejects_empty_loader(pair):
    jcfg, jstate, cfg, state = pair
    loader = [batch(2, seed=s) for s in range(3)]
    want = jinference.evaluate_mse(jcfg, jstate, iter(loader), num_batches=2)
    got = vt.evaluate_mse(cfg, state, iter(loader), num_batches=2)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    with pytest.raises(ValueError, match="empty loader"):
        vt.evaluate_mse(cfg, state, iter([]))


def test_sample_decodes_the_given_or_drawn_z(pair):
    jcfg, jstate, cfg, state = pair
    assert vt.latent_shape(cfg) == jinference.latent_shape(jcfg) == (4, 4, 16)
    z = np.random.default_rng(2).normal(size=(3, 4, 4, 16)).astype(np.float32)
    gen, _ = jinference.build_models(jcfg)
    want = gen.apply({"params": jstate.g_params, "batch_stats": jstate.g_stats}, z,
                     train=False, method=gen.decode)
    np.testing.assert_allclose(vt.sample(cfg, state, z=z).numpy(), np.asarray(want), **TOL)
    a = vt.sample(cfg, state, torch.Generator().manual_seed(5), n=4)
    b = vt.sample(cfg, state, torch.Generator().manual_seed(5), n=4)
    assert tuple(a.shape) == (4, SIZE, SIZE, 1) and torch.equal(a, b)
    with pytest.raises(ValueError):
        vt.sample(cfg, state)


def test_mean_predictor_floor_matches_jax():
    x = batch(4)
    want = jinference.mean_predictor_floor(x)
    np.testing.assert_allclose(vt.mean_predictor_floor(x, device="cpu"), want, rtol=1e-6)
    # a tensor is reduced where it lies, whatever ``device`` says
    np.testing.assert_allclose(vt.mean_predictor_floor(torch.from_numpy(x)), want, rtol=1e-6)


def test_with_ema(pair):
    _, _, cfg, state = pair
    ema = {k: torch.full_like(v, 0.5) for k, v in state.ema.items()}
    swapped = vt.with_ema(state.replace(ema=ema))
    assert all(torch.equal(p, ema[k]) for k, p in swapped.generator.named_parameters())
    assert not torch.equal(next(state.generator.parameters()), next(iter(ema.values())))
    with pytest.raises(ValueError):
        vt.with_ema(state.replace(ema=None))


def test_bundle_round_trip(pair, tmp_path):
    """The version-2 bundle: manifest fields, one ``.pt2`` program an entry,
    and outputs bitwise the in-process entry points' on the CPU."""
    _, _, cfg, state = pair
    mpath = vt.save_bundle(str(tmp_path), cfg, state)
    bundle = vt.load_bundle(str(tmp_path), device="cpu")
    for key in ("bundle_version", "platforms", "batch", "image_size", "channels",
                "latent_shape", "step", "entries", "config"):
        assert key in bundle.manifest, key
    assert bundle.manifest["bundle_version"] == serving.BUNDLE_VERSION == 2
    assert vt.Config.from_dict(bundle.manifest["config"]) == cfg
    assert bundle.latent_shape == (4, 4, 16) and set(bundle.programs) == {
        "reconstruct", "encode", "decode"}
    assert all((tmp_path / e["file"]).is_file() and e["file"].endswith(".pt2")
               for e in bundle.manifest["entries"].values())
    assert mpath.endswith(serving.MANIFEST_NAME)
    x = batch()
    rec, mse = bundle.reconstruct(x)
    want, want_mse = vt.reconstruct(cfg, state, x)
    assert torch.equal(rec, want) and torch.equal(mse, want_mse)
    z = bundle.encode(x)
    with torch.inference_mode():
        assert torch.equal(z, state.generator.encode(torch.from_numpy(x)))
        assert torch.equal(bundle.decode(z), state.generator.decode(z))


def test_entry_points_default_to_cuda(pair, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    _, _, cfg, state = pair
    vt.save_bundle(str(tmp_path), cfg, state)
    for call in (lambda: vt.build_models(cfg), lambda: vt.create_generator_state(cfg),
                 lambda: vt.create_train_state(cfg),
                 lambda: vt.load_bundle(str(tmp_path)),
                 lambda: vt.mean_predictor_floor(batch())):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_recalibrate_bn_stats_matches_jax(pair):
    """Standing BN statistics from three batches (the train-mode fused BN under
    ``torch.no_grad``, dropout off, z = mu) against the JAX package's
    ``recalibrate_bn_stats``; the parameters and the caller's state are left as
    they were. Tolerance 1e-4 relative + 1e-5."""
    jcfg, jstate, cfg, state = pair
    loader = [batch(2, seed=s) for s in range(3)]
    want = jinference.recalibrate_bn_stats(jcfg, jstate, loader, num_batches=3)
    before = {k: v.clone() for k, v in state.generator.state_dict().items()}
    got = vt.recalibrate_bn_stats(cfg, state, loader, num_batches=3)
    assert all(torch.equal(v, state.generator.state_dict()[k]) for k, v in before.items())
    sd = got.generator.state_dict()
    for k, val in vt.from_jax_variables({"batch_stats": want.g_stats}).items():
        np.testing.assert_allclose(sd[k].numpy(), val.numpy(), rtol=1e-4, atol=1e-5, err_msg=k)
    for k, v in state.generator.named_parameters():
        assert torch.equal(sd[k], v)
    with pytest.raises(ValueError, match="empty loader"):
        vt.recalibrate_bn_stats(cfg, state, [])
