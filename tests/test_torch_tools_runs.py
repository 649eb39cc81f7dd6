"""The port's research tools run on the CPU (``--device cpu``, the presets
narrowed by monkeypatch as ``tests/test_torch_examples.py`` narrows them).

- ``--keep-best``: the kept iterate stays bitwise what it was after later
  in-place steps, and the generator made from it scores what was recorded;
  only a lower score replaces it.
- ``paper_probe``'s diagnostics (eval-mode MSE of the live and the EMA
  iterate, mean |logit| of the critic on the real batch and on its
  reconstruction) against the JAX script's formulas on the same state: both
  packages start from one JAX state (``load_jax_train_state``) and take two
  paper steps with the draws injected, as ``tests/test_torch_paper_step.py``
  does, at its tolerances (2e-4 relative + 1e-5); the curve row is the
  JAX script's rounding of those values.
- Each training tool's printed JSON keys are the JAX script's (read from its
  source), and its files are written; ``edges_multiseed`` with its runs done
  in this process; ``run_256dp_virtual_mesh`` as two gloo processes.
- The kernel calls of ``gan_only_budget``, ``paper_probe`` and
  ``large_batch_recipe`` at the presets' full architectures (at 32², where
  the CPU runs each kernel's plain version) are what ``chip_smoke.py``'s
  phase 15 holds the card's launches to (``chip_smoke.tool_launches``).
"""

from __future__ import annotations

import ast
import io
import json
import subprocess
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vaegan_tpu.train.state as jstate_mod
import vaegan_tpu.train.step as jstep_mod
import vaegan_tpu_torch as vt
from test_torch_chip_smoke import _counting
from test_torch_examples import narrow
from test_torch_paper_step import BATCH, SIZE, _draws, configs
from vaegan_tpu_torch.examples import reproduce_headline
from vaegan_tpu_torch.tools import (
    conv_fusion_evidence,
    edges_multiseed,
    gan_only_budget,
    large_batch_recipe,
    paper_probe,
    run_256dp_virtual_mesh,
)
from vaegan_tpu_torch.tools.common import KeepBest, eval_mse
from vaegan_tpu_torch.train import make_paper_train_step, paper_draws

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def tiny_state(ema):
    cfg = narrow(vt.preset)("vaegan_paper")
    cfg = cfg.replace(data=cfg.data.replace(image_size=16, batch_size=4),
                      train=cfg.train.replace(ema_decay=0.9 if ema else None))
    return cfg, vt.create_train_state(cfg, device="cpu", seed=0), make_paper_train_step(cfg)


# ------------------------------------------------------------------- keep-best
@pytest.mark.parametrize("ema", [False, True], ids=["live", "ema"])
def test_keep_best_snapshot_survives_later_steps(ema):
    cfg, state, step = tiny_state(ema)
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.random((4, 16, 16, 1), dtype=np.float32)) for _ in range(4)]
    held = batches[0]
    state, _ = step(state, batches[1], 1)
    params = state.g_ema if ema else None
    score = eval_mse(cfg, vt.with_ema(state).generator if ema else state.generator, held)
    best = KeepBest()
    assert best.offer(score, 1, state.generator, params)
    kept = {k: v.clone() for k, v in {**best.params, **best.buffers}.items()}
    live = dict(state.generator.named_parameters()) if not ema else state.g_ema
    for i, b in enumerate(batches[2:]):
        state, _ = step(state, b, 2 + i)
    assert best.step == 1 and best.score == score
    assert all(torch.equal(best.params.get(k, best.buffers.get(k)), v) for k, v in kept.items())
    moved = [k for k, v in live.items() if not torch.equal(v, kept[k])]
    assert moved, "the later steps left the live tensors where they were"
    buffers = dict(state.generator.named_buffers())
    assert any(not torch.equal(buffers[k], kept[k]) for k in best.buffers)
    assert eval_mse(cfg, best.generator(state.generator), held) == score


def test_keep_best_keeps_only_a_lower_score():
    cfg, state, _ = tiny_state(False)
    best = KeepBest()
    assert best.offer(0.5, 1, state.generator)
    with torch.no_grad():
        for p in state.generator.parameters():
            p.add_(1.0)
    assert not best.offer(0.5, 2, state.generator)
    assert not best.offer(0.7, 3, state.generator)
    assert best.step == 1
    assert best.offer(0.2, 4, state.generator)
    assert best.step == 4 and best.score == 0.2
    assert all(torch.equal(best.params[k], p) for k, p in state.generator.named_parameters())


# ------------------------------------------------------------------- diagnostics
def _jax_diagnostics(jcfg, st, batch):
    """The JAX script's ``diagnostics`` and ``ema_mse``, unrounded."""
    gen, disc = jstate_mod.build_models(jcfg)
    recon = gen.apply({"params": st.g_params, "batch_stats": st.g_stats}, batch, train=False)[0]
    mse = jnp.mean(jnp.square(recon.astype(jnp.float32) - batch.astype(jnp.float32)))
    dvars = {"params": st.d_params, "batch_stats": st.d_stats, "spectral": st.d_spectral}
    lr_ = disc.apply(dvars, batch, train=False)
    lf_ = disc.apply(dvars, recon.astype(batch.dtype), train=False)
    ema = gen.apply({"params": st.g_ema, "batch_stats": st.g_stats}, batch, train=False)[0]
    ema_mse = jnp.mean(jnp.square(ema.astype(jnp.float32) - batch.astype(jnp.float32)))
    return [float(v) for v in (mse, jnp.mean(jnp.abs(lr_)), jnp.mean(jnp.abs(lf_)), ema_mse)]


@pytest.mark.parametrize("mode", ["all-vs-losses", "off-vs-off"])
def test_paper_probe_diagnostics_match_jax(mode):
    port_mode, jax_mode = mode.split("-vs-")
    jcfg, cfg = configs(port_mode, jax_mode)
    jstate = jstate_mod.create_train_state(jcfg, jax.random.key(0))
    state = vt.create_train_state(cfg, device="cpu")
    vt.load_jax_train_state(state, jstate, state.critic.pool_shape)
    jstep = jax.jit(lambda s, b, inj: jstep_mod.make_paper_train_step(jcfg, inject=inj)(
        s, b, jax.random.key(1)))
    rng = np.random.default_rng(8)
    held = rng.random((4, SIZE, SIZE, 1), dtype=np.float32)
    for i in range(2):
        batch = rng.random((BATCH, SIZE, SIZE, 1), dtype=np.float32)
        inj = _draws(rng, port_mode)
        step = make_paper_train_step(cfg, inject={k: torch.from_numpy(v) for k, v in inj.items()})
        state, metrics = step(state, torch.from_numpy(batch), 100 + i)
        if port_mode == "all":
            inj["eps"] = paper_draws(step, state.generator)["eps"].numpy()
        jstate, jmetrics = jstep(jstate, jnp.asarray(batch),
                                 {k: jnp.asarray(v) for k, v in inj.items()})
    held_t = torch.from_numpy(held)
    got = [*paper_probe.diagnostics(cfg, state, held_t),
           eval_mse(cfg, vt.with_ema(state).generator, held_t)]
    want = _jax_diagnostics(jcfg, jstate, jnp.asarray(held))
    for name, g, w in zip(("eval_mse_held", "abs_logit_real", "abs_logit_fake", "eval_mse_ema"),
                          got, want):
        assert abs(g - w) <= 1e-5 + 2e-4 * abs(w), (name, g, w)
    row = paper_probe.probe_row(cfg, state, held_t, metrics, 2, 0.04, ema=True)
    assert row == {"step": 2, "eval_mse_ema": round(got[3], 4), "eval_mse_held": round(got[0], 4),
                   "dis_l": round(float(metrics["recon_loss"]), 4),
                   "l_gan": round(float(metrics["adv_loss"]), 4),
                   "bce_real": round(float(metrics["d_real_loss"]), 4),
                   "bce_fake": round(float(metrics["d_fake_loss"]), 4),
                   "kl_per_sample": round(float(metrics["kl"]), 1),
                   "abs_logit_real": round(got[1], 2), "abs_logit_fake": round(got[2], 2),
                   "wall_s": 0.0}
    for port_key, jax_key in (("dis_l", "recon_loss"), ("l_gan", "adv_loss"),
                              ("bce_real", "d_real_loss"), ("bce_fake", "d_fake_loss")):
        w = float(jmetrics[jax_key])
        assert abs(float(metrics[jax_key]) - w) <= 1e-5 + 2e-4 * abs(w), port_key


# ------------------------------------------------------------------- the runs
def jax_keys(name: str, var: str):
    """The keys of the JAX script's dict literals assigned to (or built into)
    ``var``, conditional ``**{...}`` parts included."""
    tree = ast.parse((ROOT / "tools" / f"{name}.py").read_text())
    keys = set()

    def dict_keys(d):
        for k, v in zip(d.keys, d.values):
            if k is not None:
                keys.add(k.value)
            elif isinstance(v, ast.IfExp):
                for side in (v.body, v.orelse):
                    if isinstance(side, ast.Dict):
                        dict_keys(side)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        target = node.targets[0]
        if isinstance(target, ast.Name) and target.id == var and isinstance(node.value, ast.Dict):
            dict_keys(node.value)
        elif (isinstance(target, ast.Subscript) and isinstance(target.value, ast.Name)
              and target.value.id == var):
            keys.add(target.slice.value)
    return keys


def dict_with(name: str, key: str):
    """The keys of the JAX script's dict literal that holds ``key``,
    conditional ``**{...}`` parts included."""
    tree = ast.parse((ROOT / "tools" / f"{name}.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == key for k in node.keys):
            keys = set()
            for k, v in zip(node.keys, node.values):
                if k is not None:
                    keys.add(k.value)
                elif isinstance(v, ast.IfExp) and isinstance(v.body, ast.Dict):
                    keys |= {kk.value for kk in v.body.keys}
            return keys
    raise KeyError(key)


@pytest.fixture
def tiny(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    for mod in (paper_probe, gan_only_budget, large_batch_recipe, run_256dp_virtual_mesh,
                reproduce_headline):
        monkeypatch.setattr(mod, "preset", narrow(mod.preset))
    return tmp_path


SMALL = ["--image-size", "16", "--dataset", "24", "--device", "cpu"]


def test_paper_probe_runs_on_the_cpu(tiny, capsys):
    out = paper_probe.main(SMALL + ["--steps", "5", "--eval-every", "2", "--keep-best",
                                    "--ema-decay", "0.9", "--save-visuals", "vis",
                                    "--out", "probes/p.jsonl", "--use-pallas", "all"])
    lines = capsys.readouterr().out.strip().splitlines()
    rows = [json.loads(l) for l in lines[:-1]]
    assert [r["step"] for r in rows] == [1, 2, 4]
    assert all(set(r) == jax_keys("paper_probe", "row") for r in rows)
    assert json.loads(lines[-1]) == json.loads(json.dumps(out))
    assert set(out) == jax_keys("paper_probe", "out")
    assert out["best_iterate_step"] in (1, 2, 4)
    assert out["best_iterate_held_mse"] == min(r["eval_mse_ema"] for r in rows)
    assert len(out["eval_mse_repeat_draws_best_iterate"]) == 3
    assert all(Path(p).stat().st_size > 0 for p in out["visuals"].values())
    assert json.loads((tiny / "probes" / "p.jsonl").read_text()) == json.loads(lines[-1])


def test_gan_only_budget_runs_on_the_cpu(tiny, capsys):
    out = gan_only_budget.main(SMALL + ["--steps", "6", "--batch", "4", "--eval-every", "2",
                                        "--grid-every", "3", "--keep-best", "--out", "g"])
    assert set(out) == jax_keys("gan_only_budget", "summary")
    assert set(out["keep_best"]) == {"best_step", "best_recon_proxy", "vs_live_endpoint",
                                     "panel"}
    curve = [json.loads(l) for l in (tiny / "g" / "curve.jsonl").read_text().splitlines()]
    assert [r["step"] for r in curve] == [1, 2, 4, 6]
    assert out["keep_best"]["best_recon_proxy"] == round(min(r["recon_proxy"] for r in curve), 4)
    assert json.loads((tiny / "g" / "summary.json").read_text()) == json.loads(json.dumps(out))
    for png in ("samples_000001.png", "samples_000003.png", "samples_000006.png",
                "final_recon_panel.png", "best_recon_panel.png"):
        assert (tiny / "g" / png).stat().st_size > 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == json.loads(
        json.dumps(out))


def test_large_batch_recipe_runs_on_the_cpu(tiny, capsys):
    out = large_batch_recipe.main(SMALL + ["--steps", "8", "--batch", "4", "--log-every", "2",
                                           "--n-critics", "2", "--gp-every", "2",
                                           "--grad-accum", "2", "--ema-decay", "0.9",
                                           "--use-pallas", "all", "--save-visuals", "v"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(l)["step"] for l in lines[:-1]] == [2, 4, 6, 8]
    assert set(out) == dict_with("large_batch_recipe", "eval_mse_draws")
    assert len(out["eval_mse_draws"]) == 3 and len(out["ema_eval_mse_draws"]) == 3
    assert out["probe"]["grad_accum"] == 2 and out["visuals"]["iterate"] in ("live", "ema")


def test_edges_multiseed_runs_and_pairs_the_arms(tiny, monkeypatch, capsys):
    """Two seeds x two arms; each run is the ``reproduce_headline`` command the
    tool builds, run in this process (narrowed, two steps)."""
    ran = []

    def run(cmd, capture_output, text, env, timeout):
        i = cmd.index("-m")
        assert cmd[i + 1] == "vaegan_tpu_torch.examples.reproduce_headline"
        argv = cmd[i + 2:]
        ran.append(argv)
        buf = io.StringIO()
        with redirect_stdout(buf):
            reproduce_headline.main(argv + ["--max-steps", "2", "--draws", "2"])
        return subprocess.CompletedProcess(cmd, 0, buf.getvalue(), "")

    monkeypatch.setattr(edges_multiseed.subprocess, "run", run)
    out = edges_multiseed.main(["--seeds", "2", "--image-size", "16", "--epochs", "1",
                                "--recalibrate-bn", "2", "--dtype", "float32", "--out", "e",
                                "--use-pallas", "all", "--device", "cpu"])
    assert len(ran) == 4
    assert all(a[a.index("--device") + 1] == "cpu" and "--use-pallas" in a for a in ran)
    assert sum("--vae" in a for a in ran) == 2 and sum("--save-visuals" in a for a in ran) == 2
    assert set(out) == jax_keys("edges_multiseed", "summary")
    assert [p["seed"] for p in out["pairs"]] == [0, 1]
    runs = [json.loads(l) for l in (tiny / "e" / "runs.jsonl").read_text().splitlines()]
    assert [(r["run"], r["seed"]) for r in runs] == [("VAE-GAN", 0), ("plain-VAE", 0),
                                                     ("VAE-GAN", 1), ("plain-VAE", 1)]
    assert out["pairs"][1]["vae_recal"] == min(runs[3]["eval_mse_repeat_draws_bn_recalibrated"])
    assert json.loads((tiny / "e" / "summary.json").read_text()) == out
    capsys.readouterr()


def test_conv_fusion_evidence_runs_on_the_cpu(tmp_path, capsys):
    out = conv_fusion_evidence.main(["--channels", "16", "--image-size", "16", "--batch", "2",
                                     "--dtype", "float32", "--hlo", str(tmp_path / "ops.txt"),
                                     "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    on, off = out["modes"]["all"], out["modes"]["off"]
    assert on["kernel_calls"] == {"bn_act_dropout": 2} and off["kernel_calls"] == {}
    assert "vaegan::bn_act_dropout" in on["bytes_MB_by_op"]
    assert on["ms"] is None and off["ms"] is None       # no device time on the CPU
    # the fused chain moves fewer bytes than its separate passes
    assert on["ratio_vs_conservative"] < off["ratio_vs_conservative"]
    listing = (tmp_path / "ops.txt").read_text().splitlines()
    assert listing[0] == "# use_pallas=off" and "# use_pallas=all" in listing
    assert len(listing) == 2 + off["ops"] + on["ops"]


def test_run_256dp_virtual_mesh_two_gloo_processes_on_the_cpu(tiny, capsys):
    """Phase A (two steps, a checkpoint each), phase B (a resume for one more)
    and the live and EMA evals, over two gloo processes; the children get
    the narrowed config as JSON."""
    preset = run_256dp_virtual_mesh.preset
    run_256dp_virtual_mesh.preset = lambda n: preset(n).replace(
        data=preset(n).data.replace(image_size=16, batch_size=4))
    try:
        run_256dp_virtual_mesh.main(["--devices", "2", "--device", "cpu",
                                     "--use-pallas", "all"])
    finally:
        run_256dp_virtual_mesh.preset = preset
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(rec) == jax_keys("run_256dp_virtual_mesh", "out")
    assert rec["phase_a_steps"] == 2 and rec["phase_b_resumed_to_step"] == 3
    assert rec["mesh"] == "data=2"
    values = [rec["eval_mse_live"], rec["eval_mse_ema"], *rec["final_metrics"].values()]
    assert all(v == v and abs(v) != float("inf") for v in values)


# ------------------------------------------------------------------- phase 15's counts
COUNTED = {
    "gan_only_budget": (gan_only_budget, ["--steps", "3", "--batch", "4", "--eval-every", "2",
                                          "--grid-every", "2", "--keep-best", "--out", "g"]),
    "paper_probe": (paper_probe, ["--steps", "3", "--eval-every", "2", "--keep-best",
                                  "--ema-decay", "0.999", "--save-visuals", "v"]),
    "large_batch_recipe": (large_batch_recipe, ["--steps", "4", "--batch", "4",
                                                "--log-every", "2"]),
}


@pytest.mark.parametrize("name", sorted(COUNTED))
def test_phase15_launches_are_the_tools_kernel_calls(name, monkeypatch, tmp_path, capsys):
    import chip_smoke

    monkeypatch.chdir(tmp_path)
    mod, argv = COUNTED[name]
    counts = _counting(monkeypatch)
    mod.main(argv + ["--image-size", "32", "--dataset", "16", "--use-pallas", "all",
                     "--device", "cpu"])
    capsys.readouterr()
    assert counts == chip_smoke.tool_launches(steps=3, every=2, lbr_steps=4)[name]
