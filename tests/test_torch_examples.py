"""The port's user journeys (``vaegan_tpu_torch/examples``) against the JAX
package's scripts of the same names (``examples/``).

Config parity: each JAX script itself runs ``main()`` on an argv with its
``train`` / ``train_data_parallel`` patched to raise with the ``Config`` it was
given, and that config's ``to_dict()`` must equal the port's
``build_config`` for the same argv. The one stated difference:
``reproduce_headline`` without ``--ema-decay`` keeps the preset's EMA in the
port (``vaegan_paper``'s 0.999), where the JAX script clears it. The JAX
script's ``jax.config`` updates at import, and the environment and platform
``train_multichip --virtual`` sets, are restored after each run.

Runs: each journey's ``main(argv + ["--device", "cpu"])`` in this process at a
tiny width (the presets narrowed by monkeypatch, as ``entry._dryrun_cfg``
narrows its config), printing the JAX script's JSON keys or closing line;
``train_multichip --virtual 2`` as two gloo processes on the CPU.
"""

from __future__ import annotations

import ast
import importlib.util
import json
import os
import re
import sys
from pathlib import Path

import jax
import pytest
import torch

import vaegan_tpu.parallel.train as jparallel_train
from vaegan_tpu_torch.examples import reproduce_headline, train_multichip, train_vaegan

# the suite runs files in parallel workers; one intra-op thread each keeps
# torch from taking every core from the other workers
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT = {"reproduce_headline": reproduce_headline, "train_vaegan": train_vaegan,
        "train_multichip": train_multichip}
RESTORED_JAX_FLAGS = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
                      "jax_platforms")


class Given(Exception):
    """Raised by the patched ``train``, carrying the config it was given."""

    def __init__(self, cfg):
        super().__init__("config captured")
        self.cfg = cfg


def _raise_with(cfg, *args, **kwargs):
    raise Given(cfg)


def jax_config_of(name: str, argv, monkeypatch):
    """The config the JAX script ``examples/<name>.py`` hands its trainer."""
    saved = {k: getattr(jax.config, k) for k in RESTORED_JAX_FLAGS}
    try:
        spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                      ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        if name == "train_multichip":   # imported inside its main()
            monkeypatch.setattr(jparallel_train, "train_data_parallel", _raise_with)
        else:
            monkeypatch.setattr(mod, "train", _raise_with)
        monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
        # restored at teardown: the multichip script's --virtual appends to it
        monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
        with pytest.raises(Given) as got:
            mod.main()
        return got.value.cfg
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)


def port_config_of(name: str, argv):
    mod = PORT[name]
    return mod.build_config(mod.build_parser().parse_args(argv))


PARITY = {
    "reproduce_headline": [
        [],
        ["--vae", "--dtype", "float32", "--seed", "2", "--max-steps", "20"],
        ["--preset", "vaegan_paper", "--feature-tap", "pool", "--gamma", "10",
         "--ema-decay", "0.99"],
        ["--n-critics", "5", "--gp-every", "8", "--use-pallas", "all", "--data-dir", "nii",
         "--image-size", "96", "--batch-size", "16", "--epochs", "1", "--data-style", "edges"],
        ["--preset", "notebook_vae", "--ema-decay", "0.999", "--recalibrate-bn", "50"],
    ],
    "train_vaegan": [
        [],
        ["--epochs", "1", "--image-size", "32", "--batch-size", "8"],
        ["--data-dir", "nii", "--out", "elsewhere"],
    ],
    "train_multichip": [
        [],
        ["--model-axis", "2", "--epochs", "2", "--max-steps", "10", "--batch-size", "32"],
        ["--virtual", "2", "--image-size", "256", "--data-dir", "nii"],
    ],
}
PARITY_CASES = [(name, i) for name, sets in PARITY.items() for i in range(len(sets))]


@pytest.mark.parametrize("name,i", PARITY_CASES, ids=[f"{n}-{i}" for n, i in PARITY_CASES])
def test_build_config_is_the_jax_scripts(name, i, tmp_path, monkeypatch):
    argv = list(PARITY[name][i])
    if name != "train_multichip":
        # both scripts create their output directory before training
        argv = argv if "--out" in argv else argv + ["--out", str(tmp_path / "out")]
    monkeypatch.chdir(tmp_path)
    want = jax_config_of(name, argv, monkeypatch).to_dict()
    assert port_config_of(name, argv).to_dict() == want


def test_reproduce_headline_keeps_the_presets_ema(tmp_path, monkeypatch):
    """The one deliberate difference: the JAX script clears ``vaegan_paper``'s
    EMA when ``--ema-decay`` is not given; the port keeps it."""
    argv = ["--preset", "vaegan_paper", "--out", str(tmp_path / "out")]
    want = jax_config_of("reproduce_headline", argv, monkeypatch).to_dict()
    got = port_config_of("reproduce_headline", argv).to_dict()
    assert want["train"]["ema_decay"] is None
    assert got["train"]["ema_decay"] == 0.999
    got["train"]["ema_decay"] = None
    assert got == want


def test_reproduce_headline_refuses_vae_with_another_preset():
    with pytest.raises(SystemExit, match="--vae conflicts"):
        port_config_of("reproduce_headline", ["--vae", "--preset", "notebook"])


# ------------------------------------------------------------------- the runs
def narrow(preset):
    """``preset`` with the widths of ``entry._dryrun_cfg`` and 16 synthetic images."""
    def cut(name):
        cfg = preset(name)
        return cfg.replace(
            generator=cfg.generator.replace(depth=1, length=1, feature_size=8),
            discriminator=cfg.discriminator.replace(
                num_stride_conv1=1, num_features_conv1=8, num_blocks=(1, 1),
                num_strides_res=(1, 2), num_features_res=(16, 16), pool_size=2,
                linear_widths=(16, 8, 8)),
            data=cfg.data.replace(synthetic_size=16))
    return cut


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    for mod in PORT.values():
        monkeypatch.setattr(mod, "preset", narrow(mod.preset))
    return tmp_path


def jax_headline_keys():
    """Every key the JAX ``reproduce_headline`` can print: the literal dict's
    and each ``out[...] =`` assignment's."""
    tree = ast.parse((ROOT / "examples" / "reproduce_headline.py").read_text())
    base, extra = set(), set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "out" for t in node.targets)):
            base |= {k.value for k in node.value.keys}
        elif (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Subscript)
              and isinstance(node.targets[0].value, ast.Name)
              and node.targets[0].value.id == "out"):
            extra.add(node.targets[0].slice.value)
    return base, extra


HEADLINE_RUNS = {
    "notebook": (["--recalibrate-bn", "2", "--save-visuals", "vis"],
                 {"eval_mse_repeat_draws_bn_recalibrated", "visuals", "visuals_iterate"}),
    "vae": (["--vae", "--n-critics", "2"], {"schedule"}),
    "paper": (["--preset", "vaegan_paper"], {"feature_tap", "gamma", "eval_mse_repeat_draws_ema"}),
}


@pytest.mark.parametrize("run", list(HEADLINE_RUNS))
def test_reproduce_headline_runs_on_the_cpu(run, tiny, capsys):
    flags, conditional = HEADLINE_RUNS[run]
    out = reproduce_headline.main(
        flags + ["--image-size", "16", "--max-steps", "3", "--draws", "2", "--dtype", "float32",
                 "--use-pallas", "all", "--out", str(tiny / "h"), "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    base, extra = jax_headline_keys()
    assert set(line) == base | conditional and conditional <= extra
    assert line["steps"] == 3
    values = [*line["eval_mse_repeat_draws"], line["eval_mse_mean_predictor_floor"],
              *line["final_train_metrics"].values()]
    assert len(line["eval_mse_repeat_draws"]) == 2
    assert all(v == v and abs(v) != float("inf") for v in values)
    if run == "notebook":
        assert all(Path(p).is_file() for p in line["visuals"].values())
        assert line["reference_band"] == "0.0518-0.0573"
    if run == "paper":
        assert len(line["eval_mse_repeat_draws_ema"]) == 2


def test_train_vaegan_runs_on_the_cpu(tiny, capsys):
    mse = train_vaegan.main(["--epochs", "1", "--image-size", "16", "--batch-size", "4",
                             "--out", "v", "--device", "cpu"])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last == f"artifacts in v/ — recon MSE {mse:.4f}" and mse == mse
    for png in ("reconstructions.png", "prior_samples.png", "interpolation.png"):
        assert (tiny / "v" / png).stat().st_size > 0
    assert (tiny / "v" / "ckpt").is_dir()


CLOSING = re.compile(r"^trained (\d+) steps over (\d+) devices \((\d+) process\(es\)\) — "
                     r"[0-9.]+ img/s$")


@pytest.mark.parametrize("virtual", [0, 2], ids=["one-process", "virtual-2-gloo"])
def test_train_multichip_runs_on_the_cpu(virtual, tiny, capsys):
    argv = ["--image-size", "16", "--batch-size", "4", "--max-steps", "2", "--device", "cpu"]
    train_multichip.main(argv + (["--virtual", str(virtual)] if virtual else []))
    last = capsys.readouterr().out.strip().splitlines()[-1]
    m = CLOSING.match(last)
    assert m, last
    n = max(virtual, 1)
    assert m.groups() == ("2", str(n), str(n))


# one process of the coordinator form: narrow (this file's, by its source) then main
COORDINATED = """
import sys
import torch
from vaegan_tpu_torch.examples import train_multichip as tm

torch.set_num_threads(1)
{narrow}
tm.preset = narrow(tm.preset)
tm.main(["--image-size", "16", "--batch-size", "4", "--max-steps", "2", "--device", "cpu",
         "--coordinator", sys.argv[1], "--num-processes", "2", "--process-id", sys.argv[2]])
"""


def test_train_multichip_coordinator_form_on_the_cpu(tmp_path):
    """``--coordinator host:port --num-processes 2 --process-id i``: two
    processes meet at a ``tcp://`` rendezvous, process 0 prints the line."""
    import inspect
    import sys

    from vaegan_tpu_torch.parallel import dist

    port = dist._free_port()
    code = COORDINATED.format(narrow=inspect.getsource(narrow))
    res = dist.run_processes([[sys.executable, "-c", code, f"127.0.0.1:{port}", str(i)]
                              for i in range(2)], timeout_s=300, cwd=str(tmp_path))
    assert all(rc == 0 for rc, _, _ in res), "".join(err[-2000:] for _, _, err in res)
    m = CLOSING.match(res[0][1].strip().splitlines()[-1])
    assert m and m.groups() == ("2", "2", "2")
    assert not CLOSING.search(res[1][1])
