"""Weights across the two packages: ``from_jax_variables`` against the JAX
package's own torch export (generator and critic), strict loading, a whole JAX
train state carried into the port's, parameter counts at full width, and the
init scheme's moments."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaegan_tpu import interop as jinterop
from vaegan_tpu.config import GeneratorConfig as JGeneratorConfig
from vaegan_tpu.models import UnsupervisedGeneratorNetwork as JGenerator
import vaegan_tpu_torch as vt
from vaegan_tpu_torch.config import Config, DataConfig, GeneratorConfig
from vaegan_tpu_torch.ops import initializers as I

# the suite runs files in parallel workers; one intra-op thread each keeps
# torch from taking every core from the other workers
torch.set_num_threads(1)


def jax_generator_variables(gcfg: dict, size=16):
    gen = JGenerator(cfg=JGeneratorConfig(**gcfg))
    k = jax.random.key(0)
    return jax.jit(lambda: gen.init({"params": k, "dropout": k, "noise": k},
                                    jnp.zeros((1, size, size, 1)), train=False))()


GEN_CONFIGS = {
    "vae": dict(depth=2, length=2, feature_size=4),
    "standard": dict(depth=1, length=1, feature_size=4, res_mode="standard"),
    "non_vae": dict(depth=2, length=1, feature_size=4, is_vae=False),
}


@pytest.mark.parametrize("name", sorted(GEN_CONFIGS))
def test_from_jax_variables_matches_jax_export_and_loads_strict(name):
    v = jax_generator_variables(GEN_CONFIGS[name])
    ours = vt.from_jax_variables(v)
    theirs = jinterop.reference_generator_from_variables(v)
    assert sorted(ours) == sorted(theirs)
    for k, val in theirs.items():
        assert ours[k].dtype == torch.from_numpy(np.array(val)).dtype, k
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(val), err_msg=k)
    cfg = Config(generator=GeneratorConfig(**GEN_CONFIGS[name]), data=DataConfig(image_size=16))
    gen = vt.build_generator(cfg, device="cpu")
    gen.load_state_dict(ours, strict=True)


def test_loads_the_pt_that_vaegan_tpu_export_writes(tmp_path):
    """``vaegan-tpu export`` saves ``{k: torch.from_numpy(v.copy())}`` of the
    reference layout (cli.py:152-179); the port loads that file as it is."""
    v = jax_generator_variables(GEN_CONFIGS["vae"])
    sd = jinterop.reference_generator_from_variables(v)
    path = tmp_path / "generator.pt"
    torch.save({k: torch.from_numpy(np.asarray(val).copy()) for k, val in sd.items()}, path)
    cfg = Config(generator=GeneratorConfig(**GEN_CONFIGS["vae"]), data=DataConfig(image_size=16))
    gen = vt.build_generator(cfg, device="cpu")
    gen.load_state_dict(torch.load(path, weights_only=True), strict=True)
    w = jnp.asarray(v["params"]["decoder"]["decoder-depth_1-upsample"]["conv1"]["kernel"])
    got = getattr(gen.decoder.decoder, "decoder-depth_1-upsample").conv1.weight.detach().numpy()
    np.testing.assert_array_equal(got, np.asarray(w).transpose(2, 3, 0, 1))


def test_parameter_counts_at_notebook_width():
    gen = vt.build_generator(vt.preset("notebook"), device="cpu")
    counts = {part: sum(p.numel() for p in getattr(gen, part).parameters())
              for part in ("encoder", "decoder", "code_processor")}
    assert counts == {"encoder": 1_514_754, "decoder": 1_497_869, "code_processor": 1_180_160}


class TestInit:
    def test_kaiming_normal_matches_torch(self):
        g = torch.Generator().manual_seed(0)
        ours = I.kaiming_normal_(torch.empty(64, 32, 3, 3), g)
        ref = torch.nn.init.kaiming_normal_(torch.empty(64, 32, 3, 3))
        want = math.sqrt(2.0 / (32 * 9))
        np.testing.assert_allclose(float(ours.std()), want, rtol=0.02)
        np.testing.assert_allclose(float(ref.std()), want, rtol=0.02)

    def test_conv_transpose_keeps_torch_default_with_dim1_fan_in(self):
        cin, cout, k = 24, 12, 4
        g = torch.Generator().manual_seed(0)
        ours = I.torch_default_conv_(torch.empty(cin, cout, k, k), g)
        ref = torch.nn.ConvTranspose2d(cin, cout, k, stride=2, bias=False).weight.detach()
        bound = 1.0 / math.sqrt(cout * k * k)     # torch reads fan-in off dim 1
        for w in (ours, ref):
            assert float(w.abs().max()) <= bound + 1e-7
            np.testing.assert_allclose(float(w.std()), bound / math.sqrt(3), rtol=0.06)

    def test_generator_reference_scheme_moments(self):
        cfg = Config(generator=GeneratorConfig(depth=1, length=1, feature_size=32),
                     data=DataConfig(image_size=32))
        gen = vt.build_generator(cfg, device="cpu")
        checked = {"kaiming": 0, "convt": 0, "bn": 0, "bias": 0}
        for name, p in gen.named_parameters():
            w = p.detach().double()
            if p.dim() == 4:
                if "upsample" in name and (".conv1." in name or ".shortcut.0." in name):
                    bound = 1.0 / math.sqrt(p.shape[1] * p.shape[2] * p.shape[3])
                    assert float(w.abs().max()) <= bound + 1e-7, name
                    np.testing.assert_allclose(float(w.std()), bound / math.sqrt(3),
                                               rtol=0.25, err_msg=name)
                    checked["convt"] += 1
                else:
                    want = math.sqrt(2.0 / (p.shape[1] * p.shape[2] * p.shape[3]))
                    np.testing.assert_allclose(float(w.std()), want, rtol=0.25, err_msg=name)
                    checked["kaiming"] += 1
            elif "bn" in name or ".shortcut.1." in name:
                assert torch.equal(p, torch.ones_like(p) if name.endswith("weight")
                                   else torch.zeros_like(p)), name
                checked["bn"] += 1
            else:
                assert name.startswith("code_processor") and name.endswith("bias")
                assert torch.equal(p, torch.zeros_like(p))
                checked["bias"] += 1
        assert checked["convt"] >= 2 and checked["kaiming"] >= 6
        assert checked["bn"] >= 12 and checked["bias"] == 2

    def test_same_seed_same_weights(self):
        cfg = Config(generator=GeneratorConfig(depth=1, length=1, feature_size=4),
                     data=DataConfig(image_size=16))
        a = vt.build_generator(cfg, device="cpu", seed=3).state_dict()
        b = vt.build_generator(cfg, device="cpu", seed=3).state_dict()
        c = vt.build_generator(cfg, device="cpu", seed=4).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert not all(torch.equal(a[k], c[k]) for k in a)


CRITIC = dict(num_stride_conv1=2, num_features_conv1=4, num_blocks=(1, 2),
              num_strides_res=(2, 2), num_features_res=(8, 8), linear_widths=(16, 8))


def critic_configs():
    from vaegan_tpu.config import preset as jpreset

    jcfg = jpreset("notebook")
    jcfg = jcfg.replace(discriminator=jcfg.discriminator.replace(**CRITIC),
                        generator=jcfg.generator.replace(depth=1, feature_size=4),
                        data=jcfg.data.replace(image_size=32))
    return jcfg, Config.from_dict(jcfg.to_dict())


def test_critic_from_jax_variables_matches_jax_export_and_loads_strict():
    """The critic's rules (``res_layers.<i>.<j>``, ``weight_orig``/``weight_u``/
    ``weight_v``, the (H, W, C) -> (C, H, W) column permute of ``linear_1``)
    against the JAX package's own notebook export, after a train forward so u, v
    and the running statistics are not at their init."""
    from vaegan_tpu.train.state import build_models as jbuild_models

    jcfg, cfg = critic_configs()
    _, jdisc = jbuild_models(jcfg)
    k = jax.random.key(0)
    x = jnp.asarray(np.random.default_rng(0).normal(size=(2, 32, 32, 1)), jnp.float32)
    v = jax.jit(lambda x: jdisc.init({"params": k, "dropout": k}, x, train=False))(x)
    _, upd = jax.jit(lambda v, x: jdisc.apply(v, x, train=True, rngs={"dropout": k},
                                              mutable=["batch_stats", "spectral"]))(v, x)
    v = {**v, **upd}
    pool = jinterop.critic_pool_shape(jcfg)
    ours = vt.from_jax_variables(v, pool)
    theirs = jinterop.reference_discriminator_from_variables(v, pool)
    assert sorted(ours) == sorted(theirs)
    for key, val in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(val), err_msg=key)
    _, critic = vt.build_models(cfg, device="cpu")
    assert critic.pool_shape == pool
    critic.load_state_dict(ours, strict=True)
    with pytest.raises(ValueError, match="pool_shape"):
        vt.from_jax_variables(v)


def test_load_jax_train_state_carries_params_stats_and_rmsprop_state():
    """A JAX TrainState with every leaf moved off its init (RMSprop ``nu``, BN and
    SN state, step, G metrics, EMA) loads into the port's: modules bit for bit,
    ``square_avg`` per parameter, the step count, the G metrics and the EMA."""
    from vaegan_tpu.train.optim import RmsState
    from vaegan_tpu.train.state import create_train_state as jcreate

    jcfg, cfg = critic_configs()
    jcfg = jcfg.replace(train=jcfg.train.replace(ema_decay=0.9))
    cfg = cfg.replace(train=cfg.train.replace(ema_decay=0.9))
    jstate = jax.jit(lambda k: jcreate(jcfg, k))(jax.random.key(0))
    rng = np.random.default_rng(1)
    moved = lambda tree: jax.tree.map(  # noqa: E731
        lambda a: (np.asarray(a) + rng.random(a.shape)).astype(np.float32), tree)
    jstate = jstate.replace(
        step=np.int32(3), g_stats=moved(jstate.g_stats), d_stats=moved(jstate.d_stats),
        d_spectral=moved(jstate.d_spectral), opt_g=RmsState(nu=moved(jstate.opt_g.nu)),
        opt_d=RmsState(nu=moved(jstate.opt_d.nu)), g_ema=moved(jstate.g_ema),
        g_metrics={k: np.float32(i) for i, k in enumerate(jstate.g_metrics)})
    state = vt.create_train_state(cfg, device="cpu")
    pool = state.critic.pool_shape
    vt.load_jax_train_state(state, jstate, pool)
    assert state.step == 3
    want_g = vt.from_jax_variables({"params": jstate.g_params, "batch_stats": jstate.g_stats})
    want_d = vt.from_jax_variables({"params": jstate.d_params, "batch_stats": jstate.d_stats,
                                    "spectral": jstate.d_spectral}, pool)
    for module, want in ((state.generator, want_g), (state.critic, want_d)):
        sd = module.state_dict()
        assert all(torch.equal(sd[k], want[k]) for k in want)
    for opt, module, jopt, spectral, p in (
            (state.opt_g, state.generator, jstate.opt_g, {}, None),
            (state.opt_d, state.critic, jstate.opt_d, jstate.d_spectral, pool)):
        nu = vt.from_jax_variables({"params": jopt.nu, "spectral": spectral}, p)
        for name, param in module.named_parameters():
            assert torch.equal(opt.state[param]["square_avg"], nu[name]), name
    assert {k: float(v) for k, v in state.g_metrics.items()} == {
        k: float(v) for k, v in jstate.g_metrics.items()}
    assert all(torch.equal(state.g_ema[k], want) for k, want in
               vt.from_jax_variables({"params": jstate.g_ema}).items())


def test_notebook_critic_parameter_count():
    """The notebook critic at 256²: 139,697,217 parameters, as in the JAX package."""
    _, critic = vt.build_models(vt.preset("notebook"), device="cpu")
    assert sum(p.numel() for p in critic.parameters()) == 139_697_217
    assert critic.pool_shape == (512, 16, 16)
