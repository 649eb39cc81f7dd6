"""The port's CLI (``python -m vaegan_tpu_torch.cli``) and hyperparameter search,
after ``tests/test_cli_and_search.py``: tiny synthetic configurations on the CPU
(``--device cpu``), subcommands called in-process through ``cli.main``."""

import json
import os

import numpy as np
import pytest
import torch

import vaegan_tpu.search as jsearch
import vaegan_tpu_torch as vt
from vaegan_tpu_torch import search as S
from vaegan_tpu_torch.cli import main

torch.set_num_threads(1)

CPU = ["--device", "cpu"]


def tiny_base(tmp_path) -> vt.Config:
    base = vt.Config()
    return base.replace(
        data=base.data.replace(image_size=16, batch_size=4, synthetic=True, synthetic_size=8),
        train=base.train.replace(n_epochs=1, sample_interval=1,
                                 sample_dir=str(tmp_path / "samples")))


def tiny_arch(tmp_path) -> vt.Config:
    cfg = tiny_base(tmp_path)
    return cfg.replace(
        generator=cfg.generator.replace(depth=1, length=1, feature_size=8),
        discriminator=cfg.discriminator.replace(
            num_stride_conv1=1, num_features_conv1=8, num_blocks=(1,), num_strides_res=(2,),
            num_features_res=(16,), pool_size=2, linear_widths=(16, 8, 8)))


TINY_SPACE = {"network_depth": [1], "network_length": [1], "feature_size": [8],
              "num_features_conv1": [8], "num_blocks": [[1]], "num_strides_res": [[2]],
              "num_features_res": [[16]], "n_critics": [1]}


def _config_file(tmp_path, **train) -> str:
    cfg = tiny_arch(tmp_path)
    cfg = cfg.replace(train=cfg.train.replace(**train))
    path = str(tmp_path / "cfg.json")
    cfg.to_json(path)
    return path


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two checkpoints of the tiny configuration, trained through the CLI (2
    steps each): ``plain`` and ``ema`` (``--ema-decay 0.9``)."""
    root = tmp_path_factory.mktemp("cli")
    cfg = _config_file(root)
    out = {"cfg": cfg, "root": root}
    for name, extra in (("plain", []), ("ema", ["--ema-decay", "0.9"])):
        ck = str(root / f"ck_{name}")
        assert main(["train", "--config", cfg, "--checkpoint", ck,
                     "--metrics-jsonl", str(root / f"{name}.jsonl"), *extra, *CPU]) == 0
        out[name] = ck
    return out


# ---------------------------------------------------------------- search
class TestSearchHelpers:
    def test_check_ascending(self):
        assert S.check_ascending([1, 2, 2, 3])
        assert not S.check_ascending([2, 1])

    @pytest.mark.parametrize("seed", [0, 1, 7, 123])
    def test_same_seed_draws_the_jax_packages_params(self, seed):
        """numpy's default_rng on both sides: one seed, the same trials."""
        rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
        for _ in range(5):
            p = S.make_random_params(rng)
            assert p == jsearch.make_random_params(jrng)
            assert S.is_valid(p)
        assert S.SEARCH_SPACE == jsearch.SEARCH_SPACE

    def test_registry_dedup(self, tmp_path):
        path = tmp_path / "params.json"
        params = {"a": 1, "num_blocks": [1]}
        assert not S.check_already_done(params, path)
        S.register_in_json({"id": "x", "params": params}, path)
        assert S.check_already_done(params, path)
        assert len(json.load(open(path))) == 1

    def test_params_to_config(self):
        p = S.make_random_params(np.random.default_rng(1))
        cfg = S.params_to_config(vt.Config(), p)
        assert cfg.generator.depth == p["network_depth"]
        assert list(cfg.discriminator.num_features_res) == p["num_features_res"]
        assert cfg.optim.lr == p["lr"]
        assert cfg.train.n_critics == p["n_critics"]

    def test_params_to_config_preserves_unsearched_fields(self):
        base = vt.Config()
        base = base.replace(
            generator=base.generator.replace(in_channels=3, is_vae=False),
            discriminator=base.discriminator.replace(pool_size=2, feature_tap="pool"))
        cfg = S.params_to_config(base, S.make_random_params(np.random.default_rng(1)))
        assert (cfg.generator.in_channels, cfg.generator.is_vae) == (3, False)
        assert (cfg.discriminator.pool_size, cfg.discriminator.feature_tap) == (2, "pool")

    def test_register_if_new_atomic_dedup_and_update(self, tmp_path):
        path = tmp_path / "params.json"
        params = {"a": 1, "num_blocks": [1]}
        e1 = {"id": "x", "params": params, "status": "pending"}
        assert S.register_if_new(e1, path) is True
        assert S.register_if_new({"id": "y", "params": params, "status": "pending"},
                                 path) is False
        S.update_in_json({**e1, "status": "ok", "recon_mse": 0.5}, path)
        reg = json.load(open(path))
        assert len(reg) == 1 and reg[0]["status"] == "ok" and reg[0]["recon_mse"] == 0.5

    def test_registry_concurrent_appends_lose_nothing(self, tmp_path):
        """Four processes appending to one registry: the flock serializes the
        read-modify-writes, so no entry is lost."""
        from concurrent.futures import ProcessPoolExecutor

        path = str(tmp_path / "params.json")
        workers, per = 4, 25
        with ProcessPoolExecutor(max_workers=workers) as ex:
            list(ex.map(_append_entries, [(path, w, per) for w in range(workers)]))
        ids = [e["id"] for e in json.load(open(path))]
        assert len(ids) == len(set(ids)) == workers * per


def _append_entries(args):
    path, worker, n = args
    for i in range(n):
        S.register_in_json({"id": f"{worker}-{i}"}, path)


class TestRandomSearchRun:
    def test_one_trial_end_to_end(self, tmp_path, monkeypatch):
        monkeypatch.chdir(tmp_path)
        monkeypatch.setattr(S, "SEARCH_SPACE", {**S.SEARCH_SPACE, **TINY_SPACE})
        entries = S.random_search(tiny_base(tmp_path), n_trials=1,
                                  results_path=str(tmp_path / "r/params.json"),
                                  archive_dir=str(tmp_path / "r/archive"), seed=0,
                                  max_steps_per_trial=2, device="cpu")
        (e,) = entries
        assert e["status"] == "ok", e
        assert np.isfinite(e["recon_mse"])
        assert (tmp_path / "r" / "archive" / f"{e['id']}.png").exists()
        assert S.check_already_done(e["params"], tmp_path / "r/params.json")
        assert not (tmp_path / f"samples_{e['id']}").exists()

    def test_trial_step_budget_is_bounded(self, tmp_path, monkeypatch):
        from vaegan_tpu_torch.train import loop

        base = tiny_base(tmp_path)
        base = base.replace(train=base.train.replace(n_epochs=50))
        seen = {}
        orig = loop.train

        def spy(cfg, *a, **k):
            seen["max_steps"], seen["device"] = cfg.train.max_steps, k.get("device")
            return orig(cfg, *a, **k)

        monkeypatch.setattr(loop, "train", spy)
        monkeypatch.setattr(S, "SEARCH_SPACE", {**S.SEARCH_SPACE, **TINY_SPACE})
        (e,) = S.random_search(base, n_trials=1, results_path=str(tmp_path / "r3/params.json"),
                               archive_dir=str(tmp_path / "r3/archive"), seed=0,
                               max_steps_per_trial=3, device="cpu")
        assert seen == {"max_steps": 3, "device": "cpu"} and e["status"] == "ok"

    def test_failed_trial_is_recorded(self, tmp_path, monkeypatch):
        monkeypatch.setattr(S, "params_to_config",
                            lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom")))
        (e,) = S.random_search(tiny_base(tmp_path), n_trials=1,
                               results_path=str(tmp_path / "r2/params.json"),
                               archive_dir=str(tmp_path / "r2/archive"), seed=0, device="cpu")
        assert e["status"] == "failed" and "boom" in e["error"]


# ---------------------------------------------------------------- the CLI
def test_bench_knows_every_mode(capsys):
    """Every port bench mode passes the unknown-mode gate; a second mode makes
    the call fail on the one-mode rule before anything runs."""
    for mode in ("infer", "paper", "vae", "loop", "loader", "roofline"):
        rc = main(["bench", mode, "loader" if mode != "loader" else "vae"])
        err = capsys.readouterr().err
        assert rc == 2 and "unknown bench mode" not in err, (mode, err)
        assert "at most one bench mode" in err
    assert main(["bench", "bogus"]) == 2
    assert "unknown bench mode" in capsys.readouterr().err


def test_bench_roofline_vae_runs(capsys, monkeypatch):
    """``bench roofline vae`` (the JAX CLI's pair) runs the roofline of the
    plain-VAE step; ``roofline`` with any mode other than paper or vae is
    refused."""
    from vaegan_tpu_torch import bench

    monkeypatch.setattr(bench, "TRIAD_ELEMENTS", 1 << 16)
    for k, v in {"BENCH_BATCH": "2", "BENCH_IMAGE": "16", "BENCH_STEPS": "1",
                 "BENCH_DTYPE": "float32"}.items():
        monkeypatch.setenv(k, v)
    assert main(["bench", "roofline", "vae", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "roofline attribution, plain-VAE step (achieved-BW-normalized)"
    assert rec["step_cost_bytes_GB"] >= 0 and rec["device"] == "cpu"
    assert main(["bench", "roofline", "loop"]) == 2
    assert "'roofline' plus 'paper'|'vae'" in capsys.readouterr().err


def test_print_config(capsys):
    assert main(["print-config", "--preset", "vaegan_paper"]) == 0
    cfg = json.loads(capsys.readouterr().out)
    assert cfg["optim"]["scheme"] == "three"
    assert cfg["loss"]["reconstruction"] == "dis_l"
    assert vt.Config.from_dict(cfg) == vt.preset("vaegan_paper")


def test_train_writes_metrics_and_checkpoints(trained):
    lines = [json.loads(x) for x in open(trained["root"] / "plain.jsonl")]
    assert len(lines) == 2 and all(np.isfinite(v) for r in lines for v in r.values())
    mgr = vt.CheckpointManager(trained["plain"])
    assert mgr.latest_step() == 2 and mgr.saved_has_g_ema() is False
    assert vt.CheckpointManager(trained["ema"]).saved_has_g_ema() is True


def test_eval_and_recalibrated_eval(trained, capsys):
    for extra in ([], ["--recalibrate-bn", "3"]):
        assert main(["eval", "--config", trained["cfg"], "--checkpoint", trained["plain"],
                     *extra, *CPU]) == 0
        assert "Mean squared error" in capsys.readouterr().out


def test_train_with_hbm_cache_and_a_step_budget(tmp_path, capsys):
    cfg = _config_file(tmp_path)
    assert main(["train", "--config", cfg, "--hbm-cache", "--max-steps", "1", *CPU]) == 0
    assert "done: 1 steps" in capsys.readouterr().out


def test_eval_ema_flag(trained, capsys):
    assert main(["eval", "--config", trained["cfg"], "--ema", "--checkpoint", trained["ema"],
                 *CPU]) == 0
    assert "Mean squared error" in capsys.readouterr().out


def test_eval_ema_checkpoint_without_flag_uses_live_params(trained, capsys):
    """The restore template follows what the checkpoint carries."""
    assert main(["eval", "--config", trained["cfg"], "--checkpoint", trained["ema"], *CPU]) == 0
    assert "Mean squared error" in capsys.readouterr().out


def test_eval_ema_flag_on_plain_checkpoint_errors_clearly(trained):
    with pytest.raises(ValueError, match="no generator EMA"):
        main(["eval", "--config", trained["cfg"], "--ema", "--checkpoint", trained["plain"],
              *CPU])


def test_export_import_roundtrip(trained, tmp_path, capsys):
    """export -> import: the state_dicts are the notebook layout, the imported
    checkpoint holds the weights bitwise and evaluates to the same MSE."""
    root = trained["root"]
    g, d = str(tmp_path / "g.pt"), str(tmp_path / "d.pt")
    assert main(["export", "--config", trained["cfg"], "--checkpoint", trained["plain"],
                 "--generator-out", g, "--discriminator-out", d, *CPU]) == 0
    assert "exported generator" in capsys.readouterr().out
    gsd, dsd = torch.load(g), torch.load(d)
    assert any(k.startswith("encoder.encoder.") for k in gsd)
    assert any(k.endswith("weight_orig") for k in dsd) and any(k.endswith("weight_u") for k in dsd)
    ck2 = str(tmp_path / "ck2")
    assert main(["import", "--config", trained["cfg"], "--checkpoint", ck2, "--generator", g,
                 "--discriminator", d, *CPU]) == 0
    assert "imported generator" in capsys.readouterr().out
    cfg = vt.Config.from_json(trained["cfg"])
    a = vt.CheckpointManager(trained["plain"]).restore(vt.create_train_state(cfg, device="cpu"))
    b = vt.CheckpointManager(ck2).restore(vt.create_train_state(cfg, device="cpu"))
    assert b.step == 0
    for net in ("generator", "critic"):
        sa, sb = getattr(a, net).state_dict(), getattr(b, net).state_dict()
        assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    mses = []
    for ck in (trained["plain"], ck2):
        assert main(["eval", "--config", trained["cfg"], "--checkpoint", ck, *CPU]) == 0
        mses.append(capsys.readouterr().out)
    assert mses[0] == mses[1]
    # .npz is read too
    npz = str(root / "g.npz")
    np.savez(npz, **{k: v.numpy() for k, v in gsd.items()})
    assert main(["import", "--config", trained["cfg"], "--checkpoint", str(tmp_path / "ck3"),
                 "--generator", npz, *CPU]) == 0
    assert "fresh-initialized critic" in capsys.readouterr().out


def test_import_wrong_architecture_errors(tmp_path):
    cfg = _config_file(tmp_path)
    np.savez(str(tmp_path / "bogus.npz"),
             **{"encoder.encoder.bogus.weight": np.zeros((4, 4, 3, 3))})
    with pytest.raises(ValueError, match="does not match"):
        main(["import", "--config", cfg, "--checkpoint", str(tmp_path / "ck3"),
              "--generator", str(tmp_path / "bogus.npz"), *CPU])
    assert not (tmp_path / "ck3").exists() or not os.listdir(tmp_path / "ck3")


def test_sample_interpolate_and_export_serving(trained, tmp_path, capsys):
    cfg, ck = trained["cfg"], trained["ema"]
    assert main(["sample", "--config", cfg, "--checkpoint", ck, "-n", "4",
                 "-o", str(tmp_path / "s.png"), *CPU]) == 0
    assert main(["interpolate", "--config", cfg, "--checkpoint", ck, "--ema", "--steps", "4",
                 "-o", str(tmp_path / "i.png"), *CPU]) == 0
    assert (tmp_path / "s.png").exists() and (tmp_path / "i.png").exists()
    out = str(tmp_path / "bundle")
    assert main(["export-serving", "--config", cfg, "--checkpoint", ck, "--ema", "--out", out,
                 *CPU]) == 0
    assert "serving bundle" in capsys.readouterr().out
    bundle = vt.load_bundle(out, device="cpu")
    recon, mse = bundle.reconstruct(np.random.default_rng(0).random((2, 16, 16, 1), np.float32))
    assert recon.shape == (2, 16, 16, 1) and np.isfinite(float(mse))


def test_search_subcommand(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(S, "SEARCH_SPACE", {**S.SEARCH_SPACE, **TINY_SPACE})
    cfg = _config_file(tmp_path)
    assert main(["search", "--config", cfg, "--trials", "1", "--max-steps-per-trial", "2",
                 "--results", "r/params.json", "--archive", "r/archive", *CPU]) == 0
    assert "[search 1/1] ok" in capsys.readouterr().out
    assert json.load(open(tmp_path / "r/params.json"))[0]["status"] == "ok"


def test_dp_refuses_before_touching_a_folder(tmp_path, capsys):
    """``train --dp`` trains data-parallel (``tests/test_torch_parallel.py``
    runs it under torchrun); a global batch that the mesh and the accumulation
    cannot split is refused before any folder is touched."""
    cfg = _config_file(tmp_path)
    stale = tmp_path / "samples" / "stale.png"
    stale.parent.mkdir()
    stale.write_bytes(b"x")
    with pytest.raises(ValueError, match="divisible"):
        main(["train", "--config", cfg, "--dp", "--grad-accum", "3", "--checkpoint",
              str(tmp_path / "ck"), *CPU])
    assert stale.exists() and not (tmp_path / "ck").exists()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without CUDA")
def test_commands_default_to_cuda(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["train", "--config", _config_file(tmp_path), "--max-steps", "1"])
