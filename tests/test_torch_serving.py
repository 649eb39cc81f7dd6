"""The port's serving bundle (``vaegan_tpu_torch.serving``): the eight
behaviours ``tests/test_serving.py`` holds of the JAX bundle, each against the
port's in-process entry points, plus the bundle against JAX's
``inference.reconstruct`` on the same weights and a bundle served in a fresh
interpreter that imports no model code.

The programs are ``torch.export`` programs; on the CPU a fused BN inside them
is the registered operator's plain version (``torch.ops.vaegan.bn_act_dropout``).
Outputs are bitwise the in-process call's (the same ATen ops on the same
weights), and within the JAX test's own 1e-5 of JAX's."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from vaegan_tpu import inference as jinference
from vaegan_tpu.config import Config as JConfig
from vaegan_tpu.config import DiscriminatorConfig, GeneratorConfig
from vaegan_tpu.train import create_train_state as jcreate_train_state
import vaegan_tpu_torch as vt
from vaegan_tpu_torch import serving

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
SIZE = 16


def tiny_jcfg(tmp_path) -> JConfig:
    """``tests/test_serving.py``'s tiny config."""
    base = JConfig()
    return base.replace(
        generator=GeneratorConfig(depth=1, length=1, feature_size=8),
        discriminator=DiscriminatorConfig(
            num_stride_conv1=1, num_features_conv1=8, num_blocks=(1,),
            num_strides_res=(2,), num_features_res=(16,), pool_size=2,
            linear_widths=(16, 8, 8)),
        data=base.data.replace(image_size=SIZE, batch_size=4, synthetic=True,
                               synthetic_size=8),
        train=base.train.replace(n_epochs=1, sample_interval=10,
                                 sample_dir=str(tmp_path / "samples")))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX cfg, JAX state, port cfg, port generator state on the same weights,
    the running statistics perturbed so eval BN is exercised)."""
    jcfg = tiny_jcfg(tmp_path_factory.mktemp("serving"))
    jstate = jcreate_train_state(jcfg, jax.random.key(0))
    rng = np.random.default_rng(0)
    g_stats = jax.tree.map(
        lambda a: (np.asarray(a) + 0.3 * rng.standard_normal(a.shape) ** 2).astype(np.float32),
        jstate.g_stats)
    jstate = jstate.replace(g_stats=g_stats)
    cfg = vt.Config.from_dict(jcfg.to_dict())
    state = vt.create_generator_state(cfg, device="cpu")
    state.generator.load_state_dict(
        vt.from_jax_variables({"params": jstate.g_params, "batch_stats": g_stats}), strict=True)
    return jcfg, jstate, cfg, state


@pytest.fixture(scope="module")
def bundle_dir(pair, tmp_path_factory):
    """A bundle with a symbolic batch, for the CPU."""
    _, _, cfg, state = pair
    out = tmp_path_factory.mktemp("bundle")
    serving.save_bundle(str(out), cfg, state, platforms=("cpu",))
    return out


def images(n, seed=0):
    return np.random.default_rng(seed).random((n, SIZE, SIZE, 1), np.float32)


def test_roundtrip_parity_and_manifest(pair, bundle_dir):
    jcfg, jstate, cfg, state = pair
    bundle = serving.load_bundle(str(bundle_dir), device="cpu")
    x = images(4)
    r_srv, mse_srv = bundle.reconstruct(x)
    r_ref, mse_ref = vt.reconstruct(cfg, state, x)
    assert torch.equal(r_srv, r_ref) and torch.equal(mse_srv, mse_ref)
    r_jax, mse_jax = jinference.reconstruct(jcfg, jstate, x)
    np.testing.assert_allclose(r_srv.numpy(), np.asarray(r_jax), atol=1e-5)
    assert abs(float(mse_srv) - float(mse_jax)) < 1e-5

    m = bundle.manifest
    assert m["bundle_version"] == serving.BUNDLE_VERSION
    assert m["image_size"] == SIZE and m["channels"] == 1 and m["platforms"] == ["cpu"]
    assert m["batch"] == "symbolic"
    assert tuple(m["latent_shape"]) == vt.latent_shape(cfg)
    assert set(m["entries"]) == {"reconstruct", "encode", "decode"}
    assert m["config"]["generator"]["feature_size"] == 8
    with open(bundle_dir / serving.MANIFEST_NAME) as f:
        entries = json.load(f)["entries"]
    assert entries["reconstruct"]["in_shapes"] == [["b", SIZE, SIZE, 1]]
    assert entries["reconstruct"]["out_shapes"] == [["b", SIZE, SIZE, 1], []]
    assert entries["decode"]["in_shapes"] == [["b", *vt.latent_shape(cfg)]]
    assert entries["encode"]["in_dtypes"] == ["float32"]


def test_symbolic_batch_serves_any_size(pair, bundle_dir):
    _, _, cfg, state = pair
    bundle = serving.load_bundle(str(bundle_dir), device="cpu")
    for b in (1, 7):
        x = images(b, seed=b)
        recon, _ = bundle.reconstruct(x)
        assert recon.shape == (b, SIZE, SIZE, 1)
        assert torch.equal(recon, vt.reconstruct(cfg, state, x)[0])


def test_encode_decode_chain(pair, bundle_dir):
    jcfg, jstate, cfg, state = pair
    bundle = serving.load_bundle(str(bundle_dir), device="cpu")
    x = images(3, seed=1)
    z = bundle.encode(x)
    assert z.shape == (3,) + bundle.latent_shape
    dec = bundle.decode(z.numpy())
    assert dec.shape == x.shape
    # the serving pair is the in-framework pair, bit for bit, and JAX's within 1e-5
    assert torch.equal(dec, vt.reconstruct(cfg, state, x)[0])
    r_jax, _ = jinference.reconstruct(jcfg, jstate, x)
    np.testing.assert_allclose(dec.numpy(), np.asarray(r_jax), atol=1e-5)


def test_pinned_batch_rejects_other_sizes(pair, tmp_path):
    _, _, cfg, state = pair
    serving.save_bundle(str(tmp_path), cfg, state, platforms=("cpu",), batch_size=4)
    bundle = serving.load_bundle(str(tmp_path), device="cpu")
    assert bundle.manifest["batch"] == 4
    assert bundle.manifest["entries"]["encode"]["in_shapes"] == [[4, SIZE, SIZE, 1]]
    recon, _ = bundle.reconstruct(np.zeros((4, SIZE, SIZE, 1), np.float32))
    assert recon.shape == (4, SIZE, SIZE, 1)
    with pytest.raises(Exception):
        bundle.reconstruct(np.zeros((2, SIZE, SIZE, 1), np.float32))


def test_cross_platform_export_from_cpu_host(pair, tmp_path):
    """The default bundle lists both devices from a CPU-only host: the programs
    are stored on the CPU and moved to the device they are loaded on. A device
    the manifest does not list is refused."""
    _, _, cfg, state = pair
    serving.save_bundle(str(tmp_path / "both"), cfg, state)
    bundle = serving.load_bundle(str(tmp_path / "both"), device="cpu")
    assert bundle.manifest["platforms"] == ["cpu", "cuda"]
    x = images(2, seed=3)
    assert torch.equal(bundle.reconstruct(x)[0], vt.reconstruct(cfg, state, x)[0])
    serving.save_bundle(str(tmp_path / "card"), cfg, state, platforms=("cuda",))
    with pytest.raises(ValueError, match="exported for"):
        serving.load_bundle(str(tmp_path / "card"), device="cpu")
    with pytest.raises(ValueError, match="platforms"):
        serving.save_bundle(str(tmp_path / "tpu"), cfg, state, platforms=("cpu", "tpu"))


def test_pallas_all_config_exports_portably(pair, tmp_path):
    """A ``use_pallas="all"`` config exports its fused BNs as the registered
    operator (one call a site) and serves on the CPU through its plain version:
    the unfused model's output within the JAX test's 2e-5, JAX's too."""
    jcfg, jstate, cfg, state = pair
    cfg_all = cfg.replace(train=cfg.train.replace(use_pallas="all"))
    gen = vt.build_generator(cfg_all, device="cpu")
    gen.load_state_dict(state.generator.state_dict(), strict=True)
    serving.save_bundle(str(tmp_path), cfg_all, state.replace(generator=gen),
                        platforms=("cpu", "cuda"))
    bundle = serving.load_bundle(str(tmp_path), device="cpu")
    ops = [n for n in bundle.programs["reconstruct"].graph.nodes
           if n.target is torch.ops.vaegan.bn_act_dropout.default]
    assert len(ops) == 8                     # four blocks, two fused BNs each
    x = images(2)
    recon, _ = bundle.reconstruct(x)
    assert torch.equal(recon, vt.reconstruct(cfg_all, state.replace(generator=gen), x)[0])
    np.testing.assert_allclose(recon.numpy(), vt.reconstruct(cfg, state, x)[0].numpy(),
                               rtol=2e-5, atol=2e-5)
    r_jax, _ = jinference.reconstruct(jcfg, jstate, x)
    np.testing.assert_allclose(recon.numpy(), np.asarray(r_jax), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("version", [serving.BUNDLE_VERSION + 1, 1])
def test_other_versions_rejected(bundle_dir, tmp_path, version):
    """A future version is refused, and so is a version-1 bundle (a state_dict
    that needed the model code), with the advice to export it again."""
    shutil.copytree(bundle_dir, tmp_path, dirs_exist_ok=True)
    mpath = tmp_path / serving.MANIFEST_NAME
    m = json.loads(mpath.read_text())
    m["bundle_version"] = version
    mpath.write_text(json.dumps(m))
    with pytest.raises(ValueError, match="re-export" if version == 1 else "version"):
        serving.load_bundle(str(tmp_path), device="cpu")


def test_loading_and_serving_imports_no_model_code(bundle_dir):
    """A fresh interpreter loads the bundle and serves it with torch and
    ``ops.fused``: no model, train or inference module is imported."""
    code = ("import sys, numpy as np\n"
            "from vaegan_tpu_torch import serving\n"
            f"b = serving.load_bundle({str(bundle_dir)!r}, device='cpu')\n"
            f"r, mse = b.reconstruct(np.zeros((2, {SIZE}, {SIZE}, 1), np.float32))\n"
            "z = b.encode(np.zeros((1, 16, 16, 1), np.float32)); b.decode(z)\n"
            "print(sorted(k for k in sys.modules if k.startswith('vaegan_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = eval(out.stdout.strip().splitlines()[-1])
    assert "vaegan_tpu_torch.ops.fused" in loaded
    assert not [m for m in loaded if m.startswith(("vaegan_tpu_torch.models",
                                                   "vaegan_tpu_torch.train",
                                                   "vaegan_tpu_torch.inference"))], loaded
    assert "vaegan_tpu" not in {m.split(".")[0] for m in loaded}


def test_cli_train_then_export_serving(tmp_path, capsys, monkeypatch):
    from vaegan_tpu_torch.cli import main

    monkeypatch.chdir(tmp_path)
    cfg = vt.Config.from_dict(tiny_jcfg(tmp_path).to_dict())
    cfg = cfg.replace(train=cfg.train.replace(max_steps=2))
    cfg.to_json(str(tmp_path / "cfg.json"))
    assert main(["train", "--config", str(tmp_path / "cfg.json"), "--checkpoint",
                 str(tmp_path / "ckpt"), "--device", "cpu"]) == 0
    assert main(["export-serving", "--config", str(tmp_path / "cfg.json"), "--checkpoint",
                 str(tmp_path / "ckpt"), "--platforms", "cpu", "--batch", "2", "--out",
                 str(tmp_path / "bundle"), "--device", "cpu"]) == 0
    assert "serving bundle (cpu; batch 2)" in capsys.readouterr().out
    bundle = serving.load_bundle(str(tmp_path / "bundle"), device="cpu")
    assert bundle.manifest["platforms"] == ["cpu"] and bundle.manifest["step"] == 2
    recon, mse = bundle.reconstruct(np.zeros((2, SIZE, SIZE, 1), np.float32))
    assert recon.shape == (2, SIZE, SIZE, 1) and np.isfinite(float(mse))
