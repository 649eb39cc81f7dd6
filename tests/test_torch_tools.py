"""The port's research tools (``vaegan_tpu_torch/tools``) against the JAX
package's scripts of the same names (``tools/``), on the CPU.

- Flags: each JAX script's ``add_argument`` calls, read from its source (its
  AST), against the port's parser: the same option strings, defaults, types,
  choices, actions and destinations, plus ``--device`` on every tool and
  ``--use-pallas`` on the tools that train.
- Configs: each JAX script that builds a ``Config`` runs ``main()`` with the
  function it hands the config to (``create_train_state``,
  ``train_data_parallel`` or ``build_models``) patched to raise with it;
  its ``to_dict()`` must equal the port's ``build_config``. The scripts'
  import-time settings of JAX's compilation cache are left out
  (:func:`load_jax_tool`), and the platform and environment
  ``run_256dp_virtual_mesh`` sets are restored after each run.
- Files: ``make_nifti_dataset`` writes the JAX script's files: ``.nii``
  bitwise, ``.nii.gz`` after decompression (a gzip header holds a time).
- Host draws: every ``np.random.default_rng`` call of a run (the dataset's,
  the held batch's, each step's indices, the final draws) is recorded on both
  sides and must agree bitwise; the JAX scripts run with their models and
  steps replaced by stand-ins that compute nothing, the port's tools for
  real at a narrow width.
- The byte audits' ideal-byte formulas: the JAX scripts' own statements,
  executed for the same arguments, against the port's functions.
- ``profile_step_residual``'s reduction of a recorded event list.
"""

from __future__ import annotations

import argparse
import ast
import gzip
import importlib.util
import json
import os
import sys
from pathlib import Path
from typing import Any, NamedTuple
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vaegan_tpu.parallel.train as jparallel_train
import vaegan_tpu.train as jtrain
from test_torch_examples import narrow
from vaegan_tpu_torch.tools import (
    conv_fusion_evidence,
    edges_multiseed,
    gan_only_budget,
    large_batch_recipe,
    make_nifti_dataset,
    paper_loss_fusion_evidence,
    paper_probe,
    profile_step_residual,
    run_256dp_virtual_mesh,
)

# the suite runs files in parallel workers; one intra-op thread each keeps
# torch from taking every core from the other workers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = {m.__name__.rsplit(".", 1)[-1]: m for m in (
    make_nifti_dataset, paper_probe, gan_only_budget, large_batch_recipe, edges_multiseed,
    profile_step_residual, conv_fusion_evidence, paper_loss_fusion_evidence,
    run_256dp_virtual_mesh)}
TRAINING = {"paper_probe", "gan_only_budget", "large_batch_recipe", "edges_multiseed",
            "profile_step_residual", "run_256dp_virtual_mesh"}
RESTORED_JAX_FLAGS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
                      "jax_platforms")


CACHE_FLAGS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")


def load_jax_tool(name: str):
    """``tools/<name>.py`` as a module, its import-time updates of the
    compilation cache's settings left out: once JAX has used a persistent
    cache directory in a process it keeps writing there, and this worker's
    later tests would share the bench's cache. The caller restores the rest
    of ``jax.config``."""
    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}",
                                                  ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    update = jax.config.update

    def without_cache(key, value):
        if key not in CACHE_FLAGS:
            update(key, value)
    with mock.patch.object(jax.config, "update", without_cache):
        spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_flags():
    saved = {k: getattr(jax.config, k) for k in RESTORED_JAX_FLAGS}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


# ------------------------------------------------------------------- flags
def jax_flags_of(name: str) -> dict:
    """{option strings: the keywords of its ``add_argument`` call}, read from
    the JAX script's source."""
    tree = ast.parse((ROOT / "tools" / f"{name}.py").read_text())
    flags = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            opts = tuple(a.value for a in node.args)
            kw = {}
            for k in node.keywords:
                if k.arg == "help":
                    continue
                kw[k.arg] = k.value.id if k.arg == "type" else ast.literal_eval(k.value)
            flags[opts] = kw
    return flags


def port_flag(action: argparse.Action) -> dict:
    kind = type(action).__name__
    out = {"dest": action.dest, "default": action.default, "required": action.required,
           "type": getattr(action.type, "__name__", None),
           "choices": list(action.choices) if action.choices else None,
           "action": {"_StoreTrueAction": "store_true",
                      "_StoreFalseAction": "store_false"}.get(kind, "store")}
    return out


def want_flag(opts, kw) -> dict:
    return {"dest": kw.get("dest", opts[0].lstrip("-").replace("-", "_")),
            "default": kw.get("default", {"store_true": False,
                                          "store_false": True}.get(kw.get("action"))),
            "required": kw.get("required", False), "type": kw.get("type"),
            "choices": kw.get("choices"), "action": kw.get("action", "store")}


@pytest.mark.parametrize("name", sorted(PORT))
def test_flags_are_the_jax_scripts(name):
    parser = PORT[name].build_parser()
    got = {tuple(a.option_strings): port_flag(a) for a in parser._actions
           if a.option_strings and a.dest != "help"}
    want = {opts: want_flag(opts, kw) for opts, kw in jax_flags_of(name).items()}
    added = {("--device",)} | ({("--use-pallas",)} if name in TRAINING else set())
    assert set(got) == set(want) | added
    for opts, flag in want.items():
        assert got[opts] == flag, opts
    assert got[("--device",)]["default"] == "cuda"
    # --help shows every flag's default: the formatter adds it to every help text
    assert parser.formatter_class is argparse.ArgumentDefaultsHelpFormatter
    assert all(a.help for a in parser._actions if a.option_strings)
    if name in TRAINING:
        assert got[("--use-pallas",)]["default"] is None
        assert got[("--use-pallas",)]["choices"] == ["off", "losses", "all"]


@pytest.mark.parametrize("name", sorted(PORT))
def test_a_tool_without_a_card_raises(name, tmp_path):
    """``--device`` defaults to ``cuda``: with no card the tool raises before it
    runs anything on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    argv = {"make_nifti_dataset": ["--out", str(tmp_path / "n")],
            "gan_only_budget": ["--out", str(tmp_path / "g")],
            "edges_multiseed": ["--out", str(tmp_path / "e")]}.get(name, [])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PORT[name].main(argv)
    assert not (tmp_path / "n").exists() or not any((tmp_path / "n").iterdir())


# ------------------------------------------------------------------- configs
class Given(Exception):
    def __init__(self, cfg):
        super().__init__("config captured")
        self.cfg = cfg


def _raise_with(cfg, *args, **kwargs):
    raise Given(cfg)


def jax_config_of(name: str, argv, monkeypatch, tmp_path):
    """The config the JAX script ``tools/<name>.py`` builds for ``argv``."""
    mod = load_jax_tool(name)
    if name == "run_256dp_virtual_mesh":
        monkeypatch.setattr(jparallel_train, "train_data_parallel", _raise_with)
        monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
        monkeypatch.setattr(mod.tempfile, "TemporaryDirectory", lambda prefix: _Fixed(tmp_path))
    elif name == "profile_step_residual":
        monkeypatch.setattr(jtrain, "create_train_state", _raise_with)
    elif name == "paper_loss_fusion_evidence":
        monkeypatch.setattr(mod, "build_models", _raise_with)
    else:
        monkeypatch.setattr(mod, "create_train_state", _raise_with)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    with pytest.raises(Given) as got:
        mod.main()
    return got.value.cfg


class _Fixed:
    """A ``TemporaryDirectory`` stand-in that yields a given directory."""

    def __init__(self, path):
        self.path = str(path)

    def __enter__(self):
        return self.path

    def __exit__(self, *exc):
        return False


def port_config_of(name: str, argv, tmp_path):
    mod = PORT[name]
    args = mod.build_parser().parse_args(argv)
    if name == "run_256dp_virtual_mesh":
        return mod.build_config(args, str(tmp_path))
    return mod.build_config(args)


SMALL = ["--image-size", "16", "--dataset", "8"]
PARITY = {
    "paper_probe": [
        SMALL,
        SMALL + ["--feature-tap", "pool", "--gamma", "10", "--lr-d", "3e-5", "--kl-weight",
                 "0.5", "--recon-weight", "2", "--ema-decay", "0.999", "--dtype", "bfloat16",
                 "--seed", "3", "--batch", "2"],
        ["--image-size", "16", "--data-dir", "NII", "--keep-best", "--use-pallas", "all"],
    ],
    "gan_only_budget": [
        SMALL,
        SMALL + ["--lr-d", "3e-5", "--dtype", "float32", "--seed", "2", "--batch", "8",
                 "--use-pallas", "losses"],
    ],
    "large_batch_recipe": [
        SMALL,
        SMALL + ["--lr", "1e-4", "--lr-g", "2e-4", "--lr-d", "3e-4", "--n-critics", "5",
                 "--clip", "0", "--lambda-gp", "5", "--grad-accum", "4", "--ema-decay", "0.999",
                 "--gp-every", "8", "--dtype", "float32", "--seed", "1", "--batch", "8"],
    ],
    "profile_step_residual": [
        [], ["--vae", "--batch", "8", "--image-size", "32", "--dtype", "float32"],
        ["--paper", "--use-pallas", "all"], ["--critic-only", "--gp-every", "4"],
    ],
    "run_256dp_virtual_mesh": [["--devices", "2"], ["--devices", "4", "--no-remat",
                                                    "--steps", "3"]],
    "paper_loss_fusion_evidence": [[], ["--batch", "4", "--image-size", "32",
                                        "--dtype", "float32", "--pallas"]],
}
PARITY_CASES = [(name, i) for name, sets in PARITY.items() for i in range(len(sets))]


@pytest.fixture(scope="module")
def nii_dir(tmp_path_factory):
    """Three NIfTI files written by the port's tool."""
    out = tmp_path_factory.mktemp("nii")
    make_nifti_dataset.main(["--out", str(out), "--n", "3", "--min-size", "20",
                             "--max-size", "24", "--device", "cpu"])
    return out


@pytest.mark.parametrize("name,i", PARITY_CASES, ids=[f"{n}-{i}" for n, i in PARITY_CASES])
def test_build_config_is_the_jax_scripts(name, i, tmp_path, monkeypatch, jax_flags, nii_dir):
    argv = [str(nii_dir) if a == "NII" else a for a in PARITY[name][i]]
    if name == "gan_only_budget":
        argv += ["--out", str(tmp_path / "out")]
    monkeypatch.chdir(tmp_path)
    jax_argv = argv
    if "--use-pallas" in argv:      # the port's flag, which the JAX script has not
        i = argv.index("--use-pallas")
        jax_argv = argv[:i] + argv[i + 2:]
    want = jax_config_of(name, jax_argv, monkeypatch, tmp_path).to_dict()
    got = port_config_of(name, argv, tmp_path).to_dict()
    if jax_argv is not argv:        # the preset's value where the flag is not given
        mode = argv[argv.index("--use-pallas") + 1]
        assert got["train"]["use_pallas"] == mode
        got["train"]["use_pallas"] = want["train"]["use_pallas"]
    assert got == want


# ------------------------------------------------------------------- files
@pytest.mark.parametrize("style", ["blobs", "edges", "texture"])
def test_make_nifti_dataset_writes_the_jax_scripts_files(style, tmp_path, monkeypatch, capsys):
    argv = ["--n", "7", "--style", style, "--seed", "3", "--min-size", "20", "--max-size", "40"]
    mod = load_jax_tool("make_nifti_dataset")
    monkeypatch.setattr(sys, "argv", ["make_nifti_dataset.py", "--out", str(tmp_path / "jax"),
                                      *argv])
    mod.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = make_nifti_dataset.main(["--out", str(tmp_path / "port"), *argv, "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    for k in ("out", "wall_s"):
        del want[k], got[k]
    assert got == want
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert sum(n.endswith(".gz") for n in names) == 3
    for n in names:
        a, b = (tmp_path / "jax" / n).read_bytes(), (tmp_path / "port" / n).read_bytes()
        if n.endswith(".gz"):
            a, b = gzip.decompress(a), gzip.decompress(b)
        assert a == b, n


# ------------------------------------------------------------------- host draws
class Recording:
    """A numpy ``Generator`` that records every call and its result."""

    def __init__(self, log, seed):
        self._rng = np.random.Generator(np.random.PCG64(seed))
        self._log = log
        log.append(("default_rng", seed, None))

    def __getattr__(self, name):
        fn = getattr(self._rng, name)

        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            self._log.append((name, repr((args, sorted(kwargs.items()))),
                              np.asarray(out).tolist()))
            return out
        return call


def recording_rng(monkeypatch):
    log = []
    monkeypatch.setattr(np.random, "default_rng", lambda seed=None: Recording(log, seed))
    return log


class FakeState(NamedTuple):
    g_params: Any
    g_stats: Any
    d_params: Any
    d_stats: Any
    d_spectral: Any
    g_ema: Any


class FakeGen:
    """A JAX generator stand-in: ``apply`` returns its input as (recon, mu, lv)."""

    def apply(self, variables, x, train=False, mutable=None, rngs=None):
        out = (x, x, x)
        return (out, {}) if mutable else out


class FakeDisc:
    def apply(self, variables, x, train=False, **kw):
        return jnp.zeros((x.shape[0], 1), x.dtype)


def stand_ins(mod, monkeypatch, metrics, ema):
    def create(cfg, key):     # distinct buffers: the scripts donate the state
        leaves = [jnp.full((), float(i)) for i in range(6)]
        return FakeState(*leaves[:5], leaves[5] if ema else None)
    monkeypatch.setattr(mod, "create_train_state", create)
    monkeypatch.setattr(mod, "build_models", lambda cfg: (FakeGen(), FakeDisc()))

    def make(cfg, *a, **kw):
        return lambda state, batch, key: (state, {k: jnp.mean(batch) for k in metrics})
    for name in ("make_train_step", "make_paper_train_step"):
        if hasattr(mod, name):
            monkeypatch.setattr(mod, name, make)


DRAW_RUNS = {
    "paper_probe": (["--steps", "5", "--eval-every", "2", "--image-size", "16", "--dataset",
                     "24", "--seed", "4", "--ema-decay", "0.9"],
                    ("recon_loss", "adv_loss", "d_real_loss", "d_fake_loss", "kl")),
    "gan_only_budget": (["--steps", "4", "--batch", "4", "--eval-every", "2", "--grid-every",
                         "3", "--image-size", "16", "--dataset", "24", "--seed", "5"],
                        ("d_loss", "g_loss")),
    "large_batch_recipe": (["--steps", "13", "--batch", "4", "--log-every", "4",
                            "--image-size", "16", "--dataset", "18", "--seed", "6",
                            "--n-critics", "2", "--gp-every", "3"],
                           ("recon_loss", "d_real_loss", "d_fake_loss", "gp")),
}


@pytest.mark.parametrize("name", sorted(DRAW_RUNS))
def test_host_draws_are_the_jax_scripts(name, tmp_path, monkeypatch, jax_flags, capsys):
    argv, metrics = DRAW_RUNS[name]
    if name == "gan_only_budget":
        argv = argv + ["--out", str(tmp_path / "out")]
    mod = load_jax_tool(name)
    stand_ins(mod, monkeypatch, metrics, ema="--ema-decay" in argv)
    want = recording_rng(monkeypatch)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    mod.main()
    got = recording_rng(monkeypatch)
    port = PORT[name]
    monkeypatch.setattr(port, "preset", narrow(port.preset))
    port.main(argv + ["--device", "cpu"])
    capsys.readouterr()
    assert [c[:2] for c in got] == [c[:2] for c in want]
    assert got == want
    assert sum(c[0] in ("permutation", "integers") for c in got) >= 4


# ------------------------------------------------------------------- audits
def jax_statements(name: str, first: str, last: str) -> str:
    """The source of the JAX script's statements from the one that starts
    with ``first`` to the one that starts with ``last``."""
    lines = (ROOT / "tools" / f"{name}.py").read_text().splitlines()
    start = next(i for i, l in enumerate(lines) if l.strip().startswith(first))
    end = next(i for i, l in enumerate(lines) if i >= start and l.strip().startswith(last))
    body = lines[start:end + 1]
    indent = min(len(l) - len(l.lstrip()) for l in body if l.strip())
    return "\n".join(l[indent:] for l in body)


@pytest.mark.parametrize("args", [(128, 96, 128, 2), (8, 16, 32, 4), (3, 40, 24, 2)])
def test_conv_audit_ideal_bytes_are_the_jax_scripts(args):
    batch, image, channels, bpe = args
    ns = {"args": argparse.Namespace(batch=batch, image_size=image, channels=channels),
          "bpe": bpe}
    exec(jax_statements("conv_fusion_evidence", "def nbytes", "return n * (itemsize"), ns)
    exec(jax_statements("conv_fusion_evidence", "b, hw, c = args.batch", "ideal_cons ="), ns)
    assert conv_fusion_evidence.ideal_bytes(batch, image, channels, bpe) == (
        ns["ideal_aggr"], ns["ideal_cons"])


@pytest.mark.parametrize("args", [((128, 12, 12, 64), (128, 24, 24, 256), 2),
                                  ((4, 4, 4, 8), (4, 8), 4)])
def test_loss_audit_ideal_bytes_are_the_jax_scripts(args):
    latent, feat, bpe = args
    b, h, w, c = latent
    ns = {"b": b, "h": h, "w": w, "c": c, "feat_shape": feat, "bpe": bpe}
    exec(jax_statements("paper_loss_fusion_evidence", "latent_b =", "ideal_cons ="), ns)
    assert paper_loss_fusion_evidence.ideal_bytes(latent, feat, bpe) == (
        ns["ideal_aggr"], ns["ideal_cons"])


@pytest.mark.parametrize("tap", ["res_out", "pool", "fc1"])
def test_loss_audit_shapes_are_the_jax_scripts(tap, monkeypatch, jax_flags, capsys):
    """The latent and the Dis_l tap's shapes the port's audit computes are the
    ones the JAX script reads off its models (its own printed JSON)."""
    mod = load_jax_tool("paper_loss_fusion_evidence")
    preset = mod.preset

    def tapped(name):
        cfg = preset(name)
        return cfg.replace(discriminator=cfg.discriminator.replace(feature_tap=tap))
    monkeypatch.setattr(mod, "preset", tapped)
    argv = ["--batch", "2", "--image-size", "32", "--dtype", "float32"]
    monkeypatch.setattr(sys, "argv", ["paper_loss_fusion_evidence.py", *argv])
    mod.main()
    want = json.loads(capsys.readouterr().out)
    args = paper_loss_fusion_evidence.build_parser().parse_args(argv)
    cfg = paper_loss_fusion_evidence.build_config(args)
    cfg = cfg.replace(discriminator=cfg.discriminator.replace(feature_tap=tap))
    assert list(paper_loss_fusion_evidence.feature_shape(cfg, 2)) == want["dis_l_feature_shape"]
    monkeypatch.setattr(paper_loss_fusion_evidence, "preset", tapped)
    got = paper_loss_fusion_evidence.main(argv + ["--device", "cpu"])
    for k in ("latent_shape", "dis_l_feature_shape", "ideal_fused_MB_aggressive",
              "ideal_fused_MB_conservative"):
        assert got[k] == want[k], k


# ------------------------------------------------------------------- the profile
def test_profile_reduction_of_a_recorded_event_list():
    conv = "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_tilesize128x128"
    legacy = "void implicit_convolve_sgemm<__nv_bfloat16, __nv_bfloat16, 128, 6, 7, 3>"
    kernels = [     # (name, device us, launches, the op that launched it)
        (conv, 4000.0, 10, "aten::cudnn_convolution"),
        ("void cudnn::detail::dgrad_engine<float, 512, 6, 5, 3, 3, 3, false>", 3000.0, 6,
         "aten::convolution_backward"),
        ("sm80_xmma_wgrad_implicit_gemm_indexed_f32f32_tf32f32_f32_nhwckrsc_nhwc", 2000.0, 6,
         "aten::convolution_backward"),
        (legacy, 1200.0, 3, "aten::convolution_backward"),   # no direction in its name
        (legacy, 900.0, 2, "aten::cudnn_convolution"),
        ("ampere_sgemm_128x64_tn", 500.0, 4, "aten::mm"),
        ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>",
         300.0, 20, "aten::add"),
        ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>", 150.0, 8,
         "aten::sum"),
        ("void at::native::elementwise_kernel<128, 2, direct_copy_kernel_cuda>", 40.0, 4,
         "aten::copy_"),
        ("void bn_act_dropout_fwd_kernel<__nv_bfloat16, 8, true, false>", 6.0, 24, ""),
        ("void bn_act_dropout_bwd_kernel<float, 4, true, false>", 5.0, 24, ""),
        ("void reparam_fwd_kernel<float, false>", 1.0, 2, ""),
        ("void reparam_bwd_kernel<float, false, false>", 1.0, 2, ""),
        ("recon_sums_kernel", 0.5, 2, ""),
        (conv, 1000.0, 2, "aten::cudnn_convolution"),   # the same kernel again: rows add up
        ("mystery", 7.5, 1, ""),
    ]
    intervals = [(0.0, 5000.0), (4000.0, 8000.0), (9000.0, 9500.0)]
    out = profile_step_residual.reduce_profile(kernels, intervals, steps=2, window_ms=20.0,
                                               top=5)
    total_us = sum(k[1] for k in kernels)
    assert out["kernels_ms_per_step"] == round(total_us / 1e3 / 2, 1)
    assert out["busy_ms_per_step"] == round(8.5 / 2, 1)
    assert out["device_busy_share"] == round(8.5 / 20.0, 3)
    assert out["kernel_overlap"] == round(total_us / 1e3 / 8.5, 2)
    assert out["traced_step_time_ms"] == 10.0
    assert [r["op"] for r in out["top_ops"]][:4] == [conv, kernels[1][0], legacy,
                                                    kernels[2][0]]
    assert out["top_ops"][0] == {"op": conv, "launches": 6.0, "ms_total": 5.0,
                                 "pct_of_step_time": 25.0,
                                 "pct_of_kernel_time": round(500000.0 / total_us, 1)}
    assert out["top_ops"][2]["launches"] == 2.5 and len(out["top_ops"]) == 5
    fams = {r["op"]: r["ms_total"] for r in out["top_families"]}
    assert list(fams)[:4] == ["cudnn_conv_fwd", "cudnn_conv_dgrad", "cudnn_conv_wgrad",
                              "cudnn_conv_bwd"]
    assert fams["cudnn_conv_fwd"] == 5.9 and fams["cudnn_conv_bwd"] == 1.2
    full = profile_step_residual.reduce_profile(kernels, intervals, 2, 20.0, top=50)
    fams = {r["op"]: r["ms_total"] for r in full["top_families"]}
    assert fams["elementwise"] == 0.3 and fams["reduction"] == 0.15 and fams["copy"] == 0.04
    assert fams["gemm"] == 0.5
    assert {f"vaegan_{k}" for k in profile_step_residual.PORT_KERNELS.values()} <= set(fams)
    assert fams["vaegan_bn_act_dropout"] == 0.01 and fams["other"] == 0.01
    assert sum(r["ms_total"] for r in full["top_families"]) == pytest.approx(total_us / 1e3,
                                                                           abs=0.05)
    assert sum(r["pct_of_kernel_time"] for r in full["top_families"]) == pytest.approx(
        100.0, abs=0.5)


@pytest.mark.parametrize("name,op,fam", [
    ("void implicit_convolve_sgemm<float, float, 1024, 5, 5, 3, 3, 3, 1, true>",
     "aten::cudnn_convolution", "cudnn_conv_fwd"),
    ("void implicit_convolve_sgemm<float, float, 1024, 5, 5, 3, 3, 3, 1, true>",
     "ConvolutionBackward0", "cudnn_conv_bwd"),
    ("sm90_xmma_dgrad_implicit_gemm_bf16bf16", "aten::convolution_backward", "cudnn_conv_dgrad"),
    ("void cudnn::detail::wgrad_alg0_engine<float, 128, 6, 7, 3, 3, 5, false, 512>",
     "aten::convolution_backward", "cudnn_conv_wgrad"),
    ("void nchwToNhwcKernel<float, float, float, true, false>", "aten::convolution_backward",
     "copy"),
    ("Memcpy DtoD (Device -> Device)", "", "copy"),
    ("void bn_act_dropout_bwd_kernel<float, 4, true, false>", "aten::convolution_backward",
     "vaegan_bn_act_dropout_bwd"),
    ("void implicit_convolve_sgemm<__nv_bfloat16, __nv_bfloat16, 128, 6, 7, 3>",
     "aten::cudnn_convolution < aten::_convolution < ConvolutionBackwardBackward0",
     "cudnn_conv_double_bwd"),
    ("sm80_xmma_wgrad_implicit_gemm", "aten::convolution_backward < "
     "autograd::engine::evaluate_function: ConvolutionBackwardBackward0",
     "cudnn_conv_double_bwd"),
    # Conv2D's route (ops.conv): the penalty's wgrad and forward under its
    # double-backward node, the first-order dgrad under the input branch's
    ("sm90_xmma_wgrad_implicit_gemm_bf16bf16", "aten::convolution_backward < "
     "InputGradBackward < autograd::engine::evaluate_function: InputGradBackward",
     "cudnn_conv_double_bwd"),
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16", "aten::cudnn_convolution < aten::_convolution "
     "< aten::convolution < aten::conv2d < InputGradBackward < "
     "autograd::engine::evaluate_function: InputGradBackward", "cudnn_conv_double_bwd"),
    ("void cudnn::detail::dgrad_engine<float, 512, 6, 5, 3, 3, 3, false>",
     "aten::convolution_backward < InputGrad < _InputBranchBackward < "
     "autograd::engine::evaluate_function: _InputBranchBackward", "cudnn_conv_dgrad"),
    ("void implicit_convolve_sgemm<float, float, 1024, 5, 5, 3, 3, 3, 1, true>",
     "aten::convolution_backward < InputGrad < _InputBranchBackward", "cudnn_conv_bwd"),
])
def test_profile_families(name, op, fam):
    assert profile_step_residual.family(name, op) == fam


def test_families_of_a_recorded_penalty_backward():
    """The ops of a recorded double backward through ``Conv2D``'s route (a CPU
    profile) with a cuDNN kernel's name each: the penalty's weight gradient
    and forward convolution are the double backward's, a first-order dgrad
    and wgrad keep their own families."""
    from torch.profiler import ProfilerActivity, profile

    from vaegan_tpu_torch.ops import conv

    x = torch.randn(2, 3, 8, 8).contiguous(memory_format=torch.channels_last)
    x.requires_grad_()
    w = torch.randn(4, 3, 3, 3, requires_grad=True)
    y = conv.conv2d(x, w, None, 1, 1)
    (g,) = torch.autograd.grad(y.square().sum(), x, create_graph=True)
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        torch.autograd.grad(g.square().sum() + y.sum(), w)
    kernel = {"dgrad": "sm90_xmma_dgrad_implicit_gemm", "wgrad": "sm90_xmma_wgrad_implicit_gemm",
              "fwd": "sm90_xmma_fprop_implicit_gemm"}
    got = []
    for e in p.events():
        if e.name == "aten::convolution_backward":
            mask = e.concrete_inputs[-1]
            kind = "dgrad" if mask[0] else "wgrad"
        elif e.name == "aten::_convolution":
            kind = "fwd"
        else:
            continue
        got.append((kind, profile_step_residual.family(
            kernel[kind], profile_step_residual.context_of(e))))
    assert sorted(got) == sorted([
        ("fwd", "cudnn_conv_double_bwd"), ("wgrad", "cudnn_conv_double_bwd"),
        ("dgrad", "cudnn_conv_dgrad"), ("wgrad", "cudnn_conv_wgrad")])


class FakeProfile:
    """A torch.profiler stand-in whose trace holds ``events``."""

    def __init__(self, events):
        self._events = events

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        return self._events


class Event(NamedTuple):
    id: int
    name: str
    device_type: Any
    time_range: Any = None
    cpu_parent: Any = None
    kernels: Any = ()
    linked_correlation_id: int = 0


def test_a_profile_without_device_events_fails(monkeypatch):
    """No device event in any of the profiles taken: the run fails rather than
    print an empty table."""
    import torch.profiler as tp

    taken = []
    monkeypatch.setattr(tp, "profile", lambda *a, **k: taken.append(1) or FakeProfile([]))
    monkeypatch.setattr(profile_step_residual, "timed_steps", lambda *a: 1.0)
    with pytest.raises(SystemExit, match="no device event"):
        profile_step_residual.traced(None, None, None, 2)
    assert len(taken) == profile_step_residual.PROFILE_ATTEMPTS


def test_traced_links_each_kernel_to_its_ops(monkeypatch):
    """Each device event an op launched (the op's ``kernels``) gets the chain
    of that op and the ops around it, innermost first, so a convolution under
    the penalty's double backward is told from a forward one; a device event
    no op launched keeps its name and time with no chain."""
    import torch.profiler as tp
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import Kernel

    Span = NamedTuple("Span", [("start", float), ("end", float)])
    conv = "void implicit_convolve_sgemm<float, float, 128, 6, 7, 3, 3, 5, 1, false>"
    node = Event(1, "ConvolutionBackwardBackward0", DeviceType.CPU)
    inner = Event(2, "aten::cudnn_convolution", DeviceType.CPU, cpu_parent=node,
                  kernels=[Kernel(conv, 0, 30.0)])
    forward = Event(3, "aten::cudnn_convolution", DeviceType.CPU,
                    kernels=[Kernel(conv, 0, 10.0)])
    events = [node, inner, forward,
              Event(10, conv, DeviceType.CUDA, Span(0.0, 30.0)),
              Event(11, conv, DeviceType.CUDA, Span(30.0, 40.0)),
              Event(12, "Memcpy HtoD", DeviceType.CUDA, Span(40.0, 41.0)),
              Event(13, "Memcpy HtoD", DeviceType.CUDA, Span(45.0, 47.0)),
              Event(14, "an empty event", DeviceType.CUDA, Span(50.0, 50.0))]
    monkeypatch.setattr(tp, "profile", lambda *a, **k: FakeProfile(events))
    monkeypatch.setattr(profile_step_residual, "timed_steps", lambda *a: 0.05)
    kernels, window, owners, spans = profile_step_residual.traced(None, None, None, 1)
    assert {name for name, _, _ in owners} == {""} and spans == []
    intervals = [(a, b) for _, a, b in owners]
    assert kernels == [
        (conv, 30.0, 1, "aten::cudnn_convolution < ConvolutionBackwardBackward0"),
        (conv, 10.0, 1, "aten::cudnn_convolution"), ("Memcpy HtoD", 3.0, 2, "")]
    assert intervals == [(0.0, 30.0), (30.0, 40.0), (40.0, 41.0), (45.0, 47.0)]
    assert window == 0.05
    fams = {r["op"]: r["ms_total"] for r in profile_step_residual.reduce_profile(
        kernels, intervals, 1, window, 10)["top_families"]}
    assert fams == {"cudnn_conv_double_bwd": 0.03, "cudnn_conv_fwd": 0.01, "copy": 0.0}


def test_traced_reads_the_programs_spans(monkeypatch):
    """A kernel belongs to the program span among the ancestors of the op it
    links to, or, without that link, of the CUDA call that shares its id; a
    launch with no span among its ancestors (the autograd engine's thread)
    goes to the innermost span open when it began. A span's own device-side
    range is no kernel; ``by_span`` takes each span's union, ``idle_gaps``
    labels each gap with the span open on the host when it began."""
    import torch.profiler as tp
    from torch.autograd import DeviceType

    Span = NamedTuple("Span", [("start", float), ("end", float)])
    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    fwd_span = Event(20, "vaegan.step.d_forward", cpu, Span(0.0, 50.0))
    bwd_span = Event(22, "vaegan.step.d_backward", cpu, Span(50.0, 120.0))
    events = [
        fwd_span, bwd_span,
        Event(21, "aten::cudnn_convolution", cpu, Span(1.0, 10.0), cpu_parent=fwd_span),
        # an op whose id is a kernel's: a kernel without a link is not its
        Event(32, "aten::add", cpu, Span(11.0, 12.0), cpu_parent=fwd_span),
        # the launch of the dgrad kernel, on the autograd engine's thread
        Event(32, "cudaLaunchKernel", cpu, Span(65.0, 66.0), linked_correlation_id=99),
        Event(24, "vaegan.step.d_backward", cuda, Span(60.0, 100.0)),
        Event(30, "fprop", cuda, Span(5.0, 40.0), linked_correlation_id=21),
        Event(31, "fprop", cuda, Span(35.0, 45.0), linked_correlation_id=21),
        Event(32, "dgrad", cuda, Span(70.0, 100.0)),
        Event(33, "Memcpy HtoD", cuda, Span(110.0, 112.0)),
    ]
    monkeypatch.setattr(tp, "profile", lambda *a, **k: FakeProfile(events))
    monkeypatch.setattr(profile_step_residual, "timed_steps", lambda *a: 0.2)
    kernels, window, owners, spans = profile_step_residual.traced(None, None, None, 1)
    assert owners == [("vaegan.step.d_forward", 5.0, 40.0), ("vaegan.step.d_forward", 35.0, 45.0),
                      ("vaegan.step.d_backward", 70.0, 100.0), ("", 110.0, 112.0)]
    assert spans == [("vaegan.step.d_forward", 0.0, 50.0), ("vaegan.step.d_backward", 50.0, 120.0)]
    out = profile_step_residual.span_tables(owners, spans, 1, window, 10)
    assert out["by_span"] == [
        {"span": "vaegan.step.d_forward", "ms_per_step": 0.04, "pct_of_step_time": 20.0},
        {"span": "vaegan.step.d_backward", "ms_per_step": 0.03, "pct_of_step_time": 15.0},
        {"span": "(no span)", "ms_per_step": 0.0, "pct_of_step_time": 1.0}]
    assert out["idle_gaps"] == [{"span": "vaegan.step.d_forward", "ms": 0.025},
                                {"span": "vaegan.step.d_backward", "ms": 0.01}]
