"""The port's bench (``python -m vaegan_tpu_torch.bench``): the one-line JSON
contract of ``tests/test_bench_contract.py`` in each mode, at BENCH_BATCH=2
BENCH_IMAGE=16 BENCH_STEPS=2 on the CPU, called in-process."""

import json

import pytest
import torch

from vaegan_tpu_torch import bench
from vaegan_tpu_torch.ops import fused

torch.set_num_threads(1)

KNOBS = {"BENCH_BATCH": "2", "BENCH_IMAGE": "16", "BENCH_STEPS": "2", "BENCH_DTYPE": "float32",
         "BENCH_DATASET": "8"}


def _run(monkeypatch, capsys, args=(), **env):
    for k, v in {**KNOBS, **env}.items():
        monkeypatch.setenv(k, v)
    assert bench.main([*args, "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert lines
    for rec in lines:
        assert set(rec) >= {"metric", "value", "unit", "vs_baseline"}
        assert rec["value"] > 0
    return lines


@pytest.mark.parametrize("mode,label", [((), "VAE-GAN"), (("--paper",), "Larsen-paper"),
                                        (("--vae",), "plain-VAE")])
def test_step_modes(monkeypatch, capsys, mode, label):
    # a two-step schedule cycle (the headline's default is 40 steps)
    (rec,) = _run(monkeypatch, capsys, mode, BENCH_N_CRITICS="2", BENCH_GP_EVERY="1")
    assert label in rec["metric"] and "images/sec/cpu" in rec["metric"]
    assert rec["unit"] == "images/sec/chip"
    assert abs(rec["vs_baseline"] - round(rec["value"] / 5000.0, 3)) < 1e-9


def test_lazy_gp_and_concat_knobs_label_the_metric(monkeypatch, capsys):
    (rec,) = _run(monkeypatch, capsys, BENCH_GP_EVERY="2", BENCH_N_CRITICS="1",
                  BENCH_STEPS="4", BENCH_CRITIC_BATCHING="concat3", BENCH_PALLAS="all")
    assert "lazy GP 1/2" in rec["metric"] and "critic_batching concat3" in rec["metric"]
    assert "use_pallas all" in rec["metric"] and "4 steps" in rec["metric"]


def test_loop_mode_times_steps_of_one_run(monkeypatch, capsys):
    """``--loop`` runs ``train()`` once and times the steps after the warm-up
    inside it: a positive rate, never a difference of two runs' walls."""
    from vaegan_tpu_torch.train import loop

    calls = []
    orig = loop.train
    monkeypatch.setattr(loop, "train", lambda *a, **k: calls.append(1) or orig(*a, **k))
    (rec,) = _run(monkeypatch, capsys, ("--loop",), BENCH_GP_EVERY="2", BENCH_N_CRITICS="1",
                  BENCH_STEPS="4")
    assert calls == [1]
    assert "end-to-end training loop" in rec["metric"] and "hbm_cache" in rec["metric"]
    assert "lazy GP 1/2" in rec["metric"] and "4 steps timed inside one run" in rec["metric"]
    assert rec["unit"] == "images/sec/chip" and rec["value"] > 0
    assert abs(rec["vs_baseline"] - round(rec["value"] / 5000.0, 3)) < 1e-9


def test_infer_mode(monkeypatch, capsys):
    recon, smp, lat = _run(monkeypatch, capsys, ("--infer",))
    assert "reconstruction" in recon["metric"] and "prior-sample" in smp["metric"]
    assert lat["unit"] == "ms" and lat["vs_baseline"] is None


def test_loader_mode(monkeypatch, capsys):
    (rec,) = _run(monkeypatch, capsys, ("--loader",))
    assert rec["unit"] == "images/sec" and rec["h2d_images_per_sec"] > 0


ROOFLINE_KEYS = {"metric", "achieved_hbm_gbs_triad", "step_cost_flops_T", "step_cost_bytes_GB",
                 "step_ms", "images_per_sec", "step_implied_gbs", "fraction_of_achieved_bw",
                 "memory_floor_ms_at_achieved_bw", "device"}


@pytest.mark.parametrize("args,env,label", [
    ((), {}, "VAE-GAN"),
    (("--paper",), {}, "Larsen-paper"),
    # JAX's wording, "step" twice included
    ((), {"BENCH_CRITIC_ONLY": "1", "BENCH_GP_EVERY": "4", "BENCH_PALLAS": "all"},
     "VAE-GAN critic-only no-GP off-step"),
])
def test_roofline_prints_the_jax_keys(monkeypatch, capsys, args, env, label):
    """``--roofline`` (alone, with ``--paper``, on the critic-only off-step)
    prints one JSON line with every key of the JAX bench's roofline line and
    its label, from a triad shrunk through the module constant; the counted
    bytes cover the parameters, gradients and optimizer state, and with the
    kernels on their calls are counted."""
    monkeypatch.setattr(bench, "TRIAD_ELEMENTS", 1 << 16)
    for k, v in {**KNOBS, "BENCH_STEPS": "1", **env}.items():
        monkeypatch.setenv(k, v)
    assert bench.main([*args, "--roofline", "--device", "cpu"]) == 0
    (rec,) = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert set(rec) >= ROOFLINE_KEYS
    assert rec["metric"] == f"roofline attribution, {label} step (achieved-BW-normalized)"
    assert rec["device"] == "cpu" and rec["achieved_hbm_gbs_triad"] > 0
    assert rec["step_cost_flops"] > 0 and rec["step_cost_bytes"] >= rec["state_bytes"] > 0
    assert abs(rec["step_implied_gbs"] / rec["achieved_hbm_gbs_triad"]
               - rec["fraction_of_achieved_bw"]) < 2e-3 + 0.01 * rec["fraction_of_achieved_bw"]
    if env.get("BENCH_PALLAS") == "all":
        assert {k: v["calls"] for k, v in rec["kernels"].items()} == {
            "bn_act_dropout": 12, "reparam_kl": 1}
    # the plain versions run on the CPU: the count sees the calls, no kernel launches
    assert rec["timed_steps"] == 1
    assert rec["launches"] == rec["counted_step_launches"] == dict.fromkeys(fused.LAUNCHES, 0)


def test_roofline_takes_no_other_mode():
    with pytest.raises(SystemExit) as e:
        bench.main(["--roofline", "--loop", "--device", "cpu"])
    assert e.value.code == 2


@pytest.mark.parametrize("n_critics,gp_every,per_epoch", [(5, 8, 10), (1, 1, 10), (3, 2, 4)])
def test_warm_up_runs_every_variant_of_the_schedule(n_critics, gp_every, per_epoch):
    import vaegan_tpu_torch as vt

    cfg = vt.preset("notebook")
    cfg = cfg.replace(train=cfg.train.replace(n_critics=n_critics, gp_every=gp_every))
    warm = bench._warm_up(cfg, per_epoch)
    seen = {bench._key(cfg, gs % per_epoch, gs) for gs in range(warm)}
    assert seen == {bench._key(cfg, gs % per_epoch, gs) for gs in range(1000)}
    assert seen <= set(bench._variants(cfg))
    assert bench._key(cfg, (warm - 1) % per_epoch, warm - 1) not in {
        bench._key(cfg, gs % per_epoch, gs) for gs in range(warm - 1)}
