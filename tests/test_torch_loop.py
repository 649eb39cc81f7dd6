"""The port's training loop and checkpoints, on the CPU at 16² with the tiny
config of ``tests/test_loop_and_inference.py``.

Against the JAX package (``vaegan_tpu.train.loop.train``): spy step variants go
into both loops, which must call the same ``(do_g_update, do_gp)`` variants on
the same batches in the same order, log the same ``(epoch, i, n_batches)`` and
write the same grid files.

Against itself, bitwise: the same seed gives the same parameters; the
``hbm_cache`` feed equals the host feed; a run resumed from a full-epoch or a
mid-epoch checkpoint ends in the uninterrupted run's state (parameters, BN and
spectral buffers, optimizer state) with its losses, and decodes no completed
batch; a checkpoint round trip; the sampler leaves the state as it found it and
returns the step's own generated images.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaegan_tpu.config import Config as JConfig
from vaegan_tpu.config import DiscriminatorConfig as JDisc
from vaegan_tpu.config import GeneratorConfig as JGen
from vaegan_tpu.train.loop import train as jtrain
from vaegan_tpu.utils.metrics import MetricsLogger as JLogger
import vaegan_tpu_torch as vt
from vaegan_tpu_torch.checkpoint import CheckpointManager
from vaegan_tpu_torch.data import pipeline
from vaegan_tpu_torch.train import loop
from vaegan_tpu_torch.train.step import make_step_variants, make_train_step
from vaegan_tpu_torch.utils.metrics import MetricsLogger

# the suite runs files in parallel workers; one intra-op thread each keeps
# torch from taking every core from the other workers
torch.set_num_threads(1)


def tiny_jcfg(tmp_path: Path, tag: str = "j", **train_kw) -> JConfig:
    base = JConfig()
    return base.replace(
        generator=JGen(depth=1, length=1, feature_size=8),
        discriminator=JDisc(
            num_stride_conv1=1, num_features_conv1=8, num_blocks=(1,),
            num_strides_res=(2,), num_features_res=(16,), pool_size=2,
            linear_widths=(16, 8, 8)),
        data=base.data.replace(image_size=16, batch_size=4, synthetic=True,
                               synthetic_size=16),
        train=base.train.replace(**{"n_epochs": 1, "sample_interval": 2,
                                    "sample_dir": str(tmp_path / f"samples_{tag}"), **train_kw}))


def tiny_cfg(tmp_path: Path, tag: str = "p", **train_kw) -> vt.Config:
    """The tiny config in the port, with the fused kernels' plain versions on."""
    cfg = vt.Config.from_dict(tiny_jcfg(tmp_path, tag, **train_kw).to_dict())
    return cfg.replace(train=cfg.train.replace(use_pallas="all"))


def quiet() -> MetricsLogger:
    return MetricsLogger(sinks=[])


def run(cfg, **kw):
    return vt.train(cfg, device="cpu", logger=quiet(), **kw)


def steps_of(logger):
    return [m for m in logger.history if "_wall_s" not in m]


def conv_weight(sd: dict) -> torch.Tensor:
    return next(v for k, v in sd.items() if k.endswith("conv1.weight"))


def snapshot(state) -> dict:
    def clone(t):
        if isinstance(t, torch.Tensor):
            return t.detach().clone()
        if isinstance(t, dict):
            return {k: clone(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(clone(v) for v in t)
        return t

    return clone({"g": state.generator.state_dict(), "d": state.critic.state_dict(),
                  "opt_g": state.opt_g.state_dict(), "opt_d": state.opt_d.state_dict(),
                  "step": state.step, "g_metrics": state.g_metrics, "g_ema": state.g_ema})


def assert_tree_equal(a, b, path="state"):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype, path
        assert torch.equal(a, b), f"{path} differs"
    elif isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{path}[{i}]")
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """Two epochs (8 steps) uninterrupted, checkpoints every 2 steps."""
    tmp = tmp_path_factory.mktemp("base")
    cfg = tiny_cfg(tmp, n_epochs=2, checkpoint_dir=str(tmp / "ck"), checkpoint_every=2)
    state, logger = run(cfg)
    return {"cfg": cfg, "tmp": tmp, "state": snapshot(state), "steps": steps_of(logger)}


# ---------------------------------------------------------------- against JAX
class _Rows:
    def __init__(self):
        self.rows = []

    def write(self, epoch, n_epochs, batch, n_batches, metrics):
        self.rows.append((epoch, n_epochs, batch, n_batches))


def test_loop_schedule_matches_jax(tmp_path):
    """n_critics=2 and lazy GP every 2nd step over 2 epochs of 3 batches cut at
    5 steps (so the critic cadence, which restarts each epoch, and the GP
    cadence, which counts global steps, part ways): the same variants on the
    same batches, the same logged positions and the same grid files in both
    loops."""
    kw = dict(n_epochs=2, n_critics=2, gp_every=2, max_steps=5, sample_interval=3)
    jcfg, cfg = tiny_jcfg(tmp_path, **kw), tiny_cfg(tmp_path, **kw)
    jcfg = jcfg.replace(data=jcfg.data.replace(synthetic_size=12))
    cfg = cfg.replace(data=cfg.data.replace(synthetic_size=12))
    calls = {"jax": [], "port": []}

    def spies(key, wrap):
        def spy(variant):
            def step(state, batch, seed):
                calls[key].append((variant, np.asarray(batch)))
                return state, {"d_loss": wrap(float(len(calls[key])))}
            return step
        return {v: spy(v) for v in ((True, True), (False, True), (True, False), (False, False))}

    jrows, prows = _Rows(), _Rows()
    jtrain(jcfg, logger=JLogger(sinks=[jrows]), step_fns=spies("jax", jnp.float32))
    vt.train(cfg, device="cpu", logger=MetricsLogger(sinks=[prows]),
             step_fns=spies("port", torch.tensor))
    assert [v for v, _ in calls["port"]] == [v for v, _ in calls["jax"]] == [
        (True, True), (False, False), (True, True), (True, False), (False, True)]
    for (_, got), (_, want) in zip(calls["port"], calls["jax"]):
        np.testing.assert_array_equal(got, want)
    assert prows.rows == jrows.rows
    assert prows.rows[3] == (1, 2, 0, 3)
    assert (sorted(os.listdir(tmp_path / "samples_p")) == sorted(os.listdir(tmp_path / "samples_j"))
            == ["0.png", "3.png"])


# ---------------------------------------------------------------- reproducibility
def test_same_seed_same_state_and_a_new_seed_differs(base, tmp_path):
    state, logger = run(base["cfg"].replace(train=base["cfg"].train.replace(
        checkpoint_dir=None, sample_dir=str(tmp_path / "s"))))
    assert_tree_equal(snapshot(state), base["state"])
    assert steps_of(logger) == base["steps"]
    assert all(np.isfinite(v) for m in base["steps"] for v in m.values())
    other, _ = run(tiny_cfg(tmp_path, seed=1, max_steps=1))
    assert not torch.equal(conv_weight(other.generator.state_dict()),
                           conv_weight(base["state"]["g"]))


def test_hbm_cache_feed_equals_host_feed(base, tmp_path):
    cfg = base["cfg"]
    cfg = cfg.replace(data=cfg.data.replace(hbm_cache=True),
                      train=cfg.train.replace(checkpoint_dir=None, sample_dir=str(tmp_path / "s")))
    state, logger = run(cfg)
    assert_tree_equal(snapshot(state), base["state"])
    assert steps_of(logger) == base["steps"]


# ---------------------------------------------------------------- resume
@pytest.fixture
def decoded(monkeypatch):
    """Counts the batches the synthetic dataset decodes."""
    seen = []
    orig = pipeline.SyntheticDataset.load_batch

    def counting(self, indices):
        seen.append(list(indices))
        return orig(self, indices)

    monkeypatch.setattr(pipeline.SyntheticDataset, "load_batch", counting)
    return seen


@pytest.mark.parametrize("stop", [4, 6], ids=["full-epoch", "mid-epoch"])
def test_resume_is_bitwise_the_uninterrupted_run(base, tmp_path, decoded, stop):
    cfg = tiny_cfg(tmp_path, n_epochs=2, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2)
    first, _ = run(cfg.replace(train=cfg.train.replace(max_steps=stop)))
    assert first.step == stop
    decoded.clear()
    state, logger = run(cfg, resume=True)
    assert state.step == 8
    assert len(decoded) == 8 - stop           # completed batches are not decoded
    assert steps_of(logger) == base["steps"][stop:]
    assert_tree_equal(snapshot(state), base["state"])
    assert CheckpointManager(str(tmp_path / "ck")).all_steps() == [4, 6, 8]   # max_to_keep 3


def test_resume_at_the_budget_runs_nothing_and_keeps_the_grids(tmp_path):
    cfg = tiny_cfg(tmp_path, n_epochs=3, max_steps=3, checkpoint_dir=str(tmp_path / "ck"),
                   checkpoint_every=1)
    run(cfg)
    grids = sorted(os.listdir(tmp_path / "samples_p"))
    assert grids == ["0.png", "2.png"]
    state, logger = run(cfg, resume=True)
    assert state.step == 3 and steps_of(logger) == []
    assert sorted(os.listdir(tmp_path / "samples_p")) == grids    # not wiped on resume


def test_interrupted_checkpoint_tmp_is_ignored(tmp_path):
    ck = tmp_path / "ck"
    cfg = tiny_cfg(tmp_path, n_epochs=5, max_steps=2, checkpoint_dir=str(ck),
                   checkpoint_every=1, sample_interval=0)
    run(cfg)
    (ck / "3.pt.tmp4242").write_bytes(b"\x00partial")       # a save killed mid-write
    assert CheckpointManager(str(ck)).latest_step() == 2
    state, logger = run(cfg.replace(train=cfg.train.replace(max_steps=4)), resume=True)
    assert state.step == 4 and len(steps_of(logger)) == 2


def test_ema_round_trip_and_the_missing_flag(tmp_path):
    kw = dict(ema_decay=0.9, checkpoint_every=2)
    whole, _ = run(tiny_cfg(tmp_path, "w", n_epochs=2, checkpoint_dir=str(tmp_path / "w"), **kw))
    cfg = tiny_cfg(tmp_path, n_epochs=2, checkpoint_dir=str(tmp_path / "ck"), **kw)
    run(cfg.replace(train=cfg.train.replace(max_steps=4)))
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.saved_has_g_ema() is True
    with pytest.raises(ValueError, match="ema_decay"):
        run(cfg.replace(train=cfg.train.replace(ema_decay=None)), resume=True)
    resumed, _ = run(cfg, resume=True)
    assert_tree_equal(snapshot(resumed), snapshot(whole))
    assert any(not torch.equal(resumed.g_ema[k], p) for k, p in resumed.generator.named_parameters())


def test_resume_without_ema_starts_the_average_from_the_restored_params(tmp_path):
    cfg = tiny_cfg(tmp_path, n_epochs=2, max_steps=2, checkpoint_dir=str(tmp_path / "ck"),
                   checkpoint_every=2, sample_interval=0)
    first, _ = run(cfg)
    assert CheckpointManager(str(tmp_path / "ck")).saved_has_g_ema() is False
    params = {k: p.detach().clone() for k, p in first.generator.named_parameters()}
    seen = {}

    def step_then_look(state, batch, seed):
        seen.setdefault("ema", {k: v.clone() for k, v in state.g_ema.items()})
        return make_train_step(cfg, True)(state, batch, seed)

    cfg2 = cfg.replace(train=cfg.train.replace(max_steps=3, ema_decay=0.9))
    state, _ = run(cfg2, resume=True, step_fns=(step_then_look, step_then_look))
    assert state.step == 3
    assert_tree_equal(seen["ema"], params)


# ---------------------------------------------------------------- checkpoints
def test_checkpoint_round_trip_is_bitwise(base):
    mgr = CheckpointManager(str(base["tmp"] / "ck"))
    assert mgr.all_steps() == [4, 6, 8]
    template = vt.create_train_state(base["cfg"], device="cpu", seed=123)
    restored = mgr.restore(template)
    assert restored is template
    assert_tree_equal(snapshot(restored), base["state"])
    assert restored.opt_d.state_dict()["state"]          # RMSprop state came back
    older = mgr.restore(vt.create_train_state(base["cfg"], device="cpu"), step=6)
    assert older.step == 6
    with pytest.raises(ValueError, match="EMA"):
        ema_cfg = base["cfg"].replace(train=base["cfg"].train.replace(ema_decay=0.9))
        mgr.restore(vt.create_train_state(ema_cfg, device="cpu"))


def test_save_without_force_keeps_and_with_force_overwrites(tmp_path):
    cfg = tiny_cfg(tmp_path)
    state = vt.create_train_state(cfg, device="cpu")
    mgr = CheckpointManager(str(tmp_path / "ck"))
    mgr.save(state)
    w = conv_weight(state.generator.state_dict())
    original = w.clone()
    with torch.no_grad():
        w.add_(1.0)
    mgr.save(state)                      # the same step: kept as it was
    back = mgr.restore(vt.create_train_state(cfg, device="cpu"))
    assert torch.equal(conv_weight(back.generator.state_dict()), original)
    mgr.save(state, force=True)
    back = mgr.restore(vt.create_train_state(cfg, device="cpu"))
    assert torch.equal(conv_weight(back.generator.state_dict()), original + 1.0)
    mgr.wait()
    mgr.close()


def test_saved_has_g_ema_is_none_when_unreadable(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.latest_step() is None and mgr.saved_has_g_ema() is None
    (tmp_path / "ck" / "5.pt").write_bytes(b"not a checkpoint")
    assert mgr.latest_step() == 5 and mgr.saved_has_g_ema() is None
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore(
            vt.create_train_state(tiny_cfg(tmp_path), device="cpu"))


# ---------------------------------------------------------------- the sampler
@pytest.mark.parametrize("mode", ["all", "off"])
def test_sampler_leaves_the_state_and_returns_the_steps_gen_imgs(tmp_path, mode):
    cfg = tiny_cfg(tmp_path)
    cfg = cfg.replace(train=cfg.train.replace(use_pallas=mode))
    state = vt.create_train_state(cfg, device="cpu")
    batch = torch.from_numpy(pipeline.SyntheticDataset(4, 16).load_batch(range(4)))
    make_train_step(cfg, True)(state, batch, 5)          # non-trivial running stats
    before = snapshot(state)
    sample = loop.make_sampler(cfg)(state, batch, 77)
    assert_tree_equal(snapshot(state), before)
    seen = []
    hook = state.generator.register_forward_hook(lambda m, i, out: seen.append(out[0].detach()))
    make_train_step(cfg, False)(state, batch, 77)
    hook.remove()
    assert sample.shape == (4, 16, 16, 1)
    assert torch.equal(sample, seen[0])


# ---------------------------------------------------------------- guards
def test_nan_guard_raises_training_diverged(tmp_path):
    def spy(state, batch, seed):
        state.step += 1
        return state, {"d_loss": torch.tensor(float("nan") if state.step >= 2 else 1.0)}

    cfg = tiny_cfg(tmp_path, nan_check=True, sample_interval=0)
    with pytest.raises(vt.TrainingDiverged, match=r"non-finite metrics \['d_loss'\]"):
        run(cfg, step_fns=(spy, spy))


@pytest.mark.parametrize("change", [
    {"optim": ("scheme", "three")},
    {"train": ("grad_accum", 2)},
    {"train": ("critic_batching", "concat")},
    {"train": ("critic_batching", "concat3")},
], ids=["three-optimizer", "grad-accum", "concat", "concat3"])
def test_unsupported_configs_raise_before_touching_the_run_folders(tmp_path, change):
    """Configurations the port once refused before touching the sample folder
    or a checkpoint (the three-optimizer step, gradient accumulation, ``concat``
    and ``concat3`` critic batching) now train: two steps with finite metrics
    and a grid, in a freshly wiped sample folder."""
    cfg = tiny_cfg(tmp_path, checkpoint_dir=str(tmp_path / "ck"))
    (part, (field, value)), = change.items()
    cfg = cfg.replace(**{part: getattr(cfg, part).replace(**{field: value})})
    stale = tmp_path / "samples_p" / "stale.png"
    stale.parent.mkdir()
    stale.write_bytes(b"x")
    state, logger = run(cfg.replace(train=cfg.train.replace(max_steps=2)))
    assert state.step == 2
    history = steps_of(logger)
    assert len(history) == 2 and all(np.isfinite(v) for m in history for v in m.values())
    assert sorted(os.listdir(tmp_path / "samples_p")) == ["0.png"]       # a fresh run wipes


def test_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is taken")
    cfg = tiny_cfg(tmp_path)
    for fn in (lambda: vt.train(cfg), lambda: loop.train(cfg),
               lambda: vt.experiment(config_overrides=cfg)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()
    assert not (tmp_path / "samples_p").exists()


def test_step_seed_is_a_pure_function_of_seed_and_step():
    seeds = {(s, g): loop.step_seed(s, g) for s in range(4) for g in range(256)}
    assert len(set(seeds.values())) == len(seeds)
    assert all(0 <= v < 2 ** 64 for v in seeds.values())
    assert loop.step_seed(3, 17) == seeds[(3, 17)]
    torch.Generator().manual_seed(max(seeds.values()))   # a valid torch seed


def test_lazy_gp_needs_all_four_variants(tmp_path):
    cfg = tiny_cfg(tmp_path, gp_every=2)
    with pytest.raises(ValueError, match="2-tuple"):
        vt.train(cfg, device="cpu", step_fns=(None, None))
    variants = make_step_variants(cfg, lambda g, gp, s: None)
    del variants[(False, False)]
    with pytest.raises(ValueError, match="missing"):
        vt.train(cfg, device="cpu", step_fns=variants)
