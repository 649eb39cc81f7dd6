"""Weights across the two packages: ``from_jax_variables`` against the JAX
package's own torch export, strict loading, parameter counts at full width, and
the init scheme's moments."""

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
    gen = vt.build_models(cfg, device="cpu")
    gen.load_state_dict(ours, strict=True)


def test_loads_the_pt_that_vaegan_tpu_export_writes(tmp_path):
    """``vaegan-tpu export`` saves ``{k: torch.from_numpy(v.copy())}`` of the
    reference layout (cli.py:152-179); the port loads that file as it is."""
    v = jax_generator_variables(GEN_CONFIGS["vae"])
    sd = jinterop.reference_generator_from_variables(v)
    path = tmp_path / "generator.pt"
    torch.save({k: torch.from_numpy(np.asarray(val).copy()) for k, val in sd.items()}, path)
    cfg = Config(generator=GeneratorConfig(**GEN_CONFIGS["vae"]), data=DataConfig(image_size=16))
    gen = vt.build_models(cfg, device="cpu")
    gen.load_state_dict(torch.load(path, weights_only=True), strict=True)
    w = jnp.asarray(v["params"]["decoder"]["decoder-depth_1-upsample"]["conv1"]["kernel"])
    got = getattr(gen.decoder.decoder, "decoder-depth_1-upsample").conv1.weight.detach().numpy()
    np.testing.assert_array_equal(got, np.asarray(w).transpose(2, 3, 0, 1))


def test_parameter_counts_at_notebook_width():
    gen = vt.build_models(vt.preset("notebook"), device="cpu")
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
        gen = vt.build_models(cfg, device="cpu")
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
        a = vt.build_models(cfg, device="cpu", seed=3).state_dict()
        b = vt.build_models(cfg, device="cpu", seed=3).state_dict()
        c = vt.build_models(cfg, device="cpu", seed=4).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert not all(torch.equal(a[k], c[k]) for k in a)
