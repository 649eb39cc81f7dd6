"""The data x model mesh in the port (``vaegan_tpu_torch.parallel``) on the CPU:
one world of four gloo processes, a 2 x 2 mesh, each process started as its
own Python process (``tests/_torch_dp_worker.py``) with a file store in a
temporary directory and a time limit of its own.

What is held:

- the 2 x 2 step with tensor parallelism of the critic head and H split over
  the model axis (``batch_sharding(mesh, spatial_axis="model")``), two steps
  (G + D, then critic only) with the critic's masks and the penalty's alphas
  injected and the generator's dropout and noise drawn by the fused kernels'
  plain versions through the stripe map, against the one-process step on the
  global batch: metrics, gradients (each process's rows of a split kernel
  against those rows of the one-process gradient), BN statistics, spectral
  vectors, RMSprop state, parameters and EMA, at the tolerances of
  ``tests/test_torch_parallel.py``; the same for a 2 x 2 mesh with tensor
  parallelism only (the model axis holds the same rows), for the Larsen step
  and for ``grad_accum=2`` on the full 2 x 2 mesh;
- copies are bitwise equal: every replicated tensor on all four processes,
  each slice of a split kernel on the two processes of its model index;
- the same 2 x 2 step against the JAX package's 2 x 2 step with the
  ``state_shardings`` tensor parallelism and ``spatial_axis="model"`` on four
  of the conftest's virtual CPU devices, from the same weights with the same
  draws, at ``tests/test_parallel.py``'s tolerances (metrics 2e-3 relative +
  1e-5, parameters 2e-3 relative + 5e-4, the weight clamp's scale);
- the spatially split eval-mode generator forward against the unsplit one,
  1e-5 (``tests/test_parallel.py``'s spatial test);
- the plain versions of rows 1-4 with a stripe map against the matching slice
  of the global draw, bitwise;
- ``state_shardings`` marks the critic's ``linear_1``-``linear_3`` kernels and
  their RMSprop state, and nothing else;
- a tensor-parallel checkpoint restores into a one-process state, and a
  one-process checkpoint into a tensor-parallel one; ``cli train --dp`` with
  ``parallel.num_model`` 2 under ``torchrun`` (``train_data_parallel`` of a
  1 x 2 mesh) writes one that does.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vaegan_tpu.train.state as jstate_mod
import vaegan_tpu.train.step as jstep_mod
from vaegan_tpu.config import Config as JConfig
from vaegan_tpu.parallel import batch_sharding as jbatch_sharding
from vaegan_tpu.parallel import make_mesh as jmake_mesh
from vaegan_tpu.parallel import replicated as jreplicated
from vaegan_tpu.parallel import shard_state as jshard_state
from vaegan_tpu.parallel import state_shardings as jstate_shardings
import vaegan_tpu_torch as vt
from vaegan_tpu_torch.checkpoint import CheckpointManager
from vaegan_tpu_torch.interop import from_jax_variables
from vaegan_tpu_torch.ops import fused
from vaegan_tpu_torch.ops.replica import Replica
from vaegan_tpu_torch.parallel import Mesh, state_shardings

sys.path.insert(0, str(Path(__file__).parent))
import _torch_dp_worker as worker  # noqa: E402
from test_torch_parallel import (  # noqa: E402
    BATCH,
    ROOT,
    RUN_TIMEOUT_S,
    SIZE,
    _batches,
    _close,
    _critic_masks,
    _grad_tol,
    _hold_state,
    _to_jax_inject,
    paper_cfg,
    run_world,
    tiny_cfg,
)

torch.set_num_threads(1)

WORLD, MODEL = 4, 2
STEPS = (True, False)
# rank r of the world is process (r // 2, r % 2): ranks 0 and 1 hold data row 0
ROW0 = (0, 1)
# the kernels the model axis splits (cfg2d's linear_1 and linear_2)
SPLIT = {"linear_1.weight", "linear_2.weight"}


def cfg2d(**train) -> vt.Config:
    """The DP tests' tiny config: over two model processes its head splits
    linear_1 and linear_2 (16 and 8 outputs) and keeps linear_3 (one output)
    whole, as the notebook's splits linear_1-3 and keeps linear_4. (With a
    third hidden linear of 8, the clamp to 0.01 leaves this tiny critic flat
    after one update, its gradients at the noise of the summation order.)"""
    return tiny_cfg(**train)


def _injected_steps(critic, seed: int, paper: bool = False):
    """Two steps of global batches with the critic's masks (and the penalty's
    alphas) drawn here for injection."""
    rng = np.random.default_rng(seed)
    keys = ("real", "tilde", "prior") if paper else ("real", "fake", "interp")
    steps = []
    for i, do_g in enumerate(STEPS):
        inj = {f"d_masks_{k}": _critic_masks(critic, rng, BATCH)
               for k in keys + (("gen",) if do_g and not paper else ())}
        if not paper:
            inj["alpha"] = torch.from_numpy(rng.random(BATCH).astype(np.float32))
        batch = torch.from_numpy(rng.random((BATCH, SIZE, SIZE, 1), dtype=np.float32))
        steps.append((do_g, batch, 300 + i, inj))
    return steps


def _jax_cfg(cfg: vt.Config):
    jcfg = JConfig.from_dict(cfg.to_dict())
    return jcfg.replace(train=jcfg.train.replace(use_pallas="losses"))


@pytest.fixture(scope="module")
def jax_init():
    """The JAX package's initial state and the port's state loaded from it."""
    cfg = cfg2d()
    jstate = jstate_mod.create_train_state(_jax_cfg(cfg), jax.random.key(0))
    state = vt.create_train_state(cfg, device="cpu")
    vt.load_jax_train_state(state, jstate, state.critic.pool_shape)
    return cfg, jstate, state


def _plan(jax_init, tmp: Path) -> dict:
    """The cases of the 2 x 2 world. The injected one-process comparisons run
    without the weight clamp: clamping every critic parameter (BN scales
    included) to 0.01 leaves this tiny critic flat after its first update
    (penalty 1, gradients ~1e-7), where its gradients are the noise of the
    summation order, for the 2 x 1 data-parallel path on the same data as much
    as for this one. The clamp, elementwise on every process's copy, runs in
    the ``accum`` case and in the JAX comparison (``jax``, from the JAX
    package's initial weights, held at tests/test_parallel.py's bounds)."""
    cfg, _, state = jax_init
    init = {"generator": state.generator.state_dict(), "critic": state.critic.state_dict()}
    one = vt.create_train_state(cfg, device="cpu")
    CheckpointManager(str(tmp / "one")).save(one)
    steps = _injected_steps(one.critic, 21)
    free = cfg.replace(loss=cfg.loss.replace(clip_value=None)).to_dict()
    pcfg = paper_cfg()
    pstate = vt.create_train_state(pcfg, device="cpu")
    for seen, process in SEEN.items():      # a step-0 file that one process alone sees
        (tmp / f"{seen}_{process}").mkdir()
        (tmp / f"{seen}_{process}" / "0.pt").write_bytes(OTHER_FILE)
    return {
        "tps": {"cfg": free, "init": None, "steps": steps, "tp": True,
                "spatial": True, "save": str(tmp / "tps"), "load": str(tmp / "one")},
        "tp": {"cfg": free, "init": None, "steps": steps, "tp": True},
        "jax": {"cfg": cfg.to_dict(), "init": init, "steps": _injected_steps(state.critic, 25),
                "tp": True, "spatial": True},
        "paper": {"cfg": pcfg.to_dict(), "init": None, "tp": True, "spatial": True,
                  "steps": _injected_steps(pstate.critic, 22, paper=True)},
        "accum": {"cfg": cfg2d(grad_accum=2).to_dict(), "init": None, "tp": True,
                  "spatial": True,
                  "steps": [(g, b, 400 + i, None) for i, (g, b) in
                            enumerate(zip(STEPS, _batches(2, 23)))]},
        "forward": {"cfg": cfg.to_dict(), "forward": torch.rand(
            (4, 2 * SIZE, 2 * SIZE, 1), generator=torch.Generator().manual_seed(24))},
        **{seen: {"cfg": cfg.to_dict(), "init": None, "steps": [], "tp": True,
                  "save": str(tmp / f"{seen}_{{process}}")} for seen in SEEN},
    }


@pytest.fixture(scope="module")
def world2d(jax_init, tmp_path_factory):
    """The plan over the 2 x 2 mesh (all four ranks' results) and, lazily, over
    one process."""
    tmp = tmp_path_factory.mktemp("mesh2d")
    plan = _plan(jax_init, tmp)
    ranks = run_world(tmp, plan, world=WORLD, num_model=MODEL)
    cache = {}

    def one(name):
        if name not in cache:
            cache[name] = worker.run(plan[name])
        return cache[name]

    return plan, ranks, one, tmp


def _whole(ranks, name: str) -> dict:
    """Data row 0's results with each split kernel (and its RMSprop state)
    put back together from the two model indices' slices."""
    a, b = (ranks[r][name] for r in ROW0)
    out = {**a, "critic": dict(a["critic"]), "nu_d": dict(a["nu_d"])}
    for k in SPLIT:
        out["critic"][k] = torch.cat([a["critic"][k], b["critic"][k]])
        out["nu_d"][k] = torch.cat([a["nu_d"][k], b["nu_d"][k]])
    return out


CASES = ("tps", "tp", "paper", "accum")
# save cases: the process that alone finds a file at the step's checkpoint path
SEEN = {"seen_by_1": 1, "seen_by_0": 0}
OTHER_FILE = b"not this run's checkpoint"
STEP_CASES = [(name, i) for name in CASES for i in range(len(STEPS))]


@pytest.mark.parametrize("name,i", STEP_CASES, ids=[f"{n}-step{i}" for n, i in STEP_CASES])
def test_2d_step_matches_one_process_step(world2d, name, i):
    """Metrics and gradients of step i, the 2 x 2 mesh against one process;
    each model index's gradient of a split kernel against its rows."""
    _, ranks, one, _ = world2d
    want = one(name)["steps"][i]
    for m in ROW0:
        got = ranks[m][name]["steps"][i]
        assert set(got["metrics"]) == set(want["metrics"])
        for k, w in want["metrics"].items():
            _close(got["metrics"][k], w, f"metric {k}", 2e-4, 1e-5)
        for net in ("g", "d"):
            w = want[f"{net}_grads"]
            assert bool(got[f"{net}_grads"]) == bool(w), net
            if w:
                tol = _grad_tol(w)
                for k in w:
                    g = got[f"{net}_grads"][k]
                    rows = w[k] if g.shape == w[k].shape else \
                        w[k].chunk(MODEL)[m]
                    _close(g, rows, f"{net} grad {k} (model index {m})", 0.0, tol[k])


@pytest.mark.parametrize("name", CASES)
def test_2d_state_matches_one_process_state(world2d, name):
    """After two steps: parameters, BN, SN, RMSprop state and EMA, the split
    kernels put back together."""
    _, ranks, one, _ = world2d
    _hold_state(_whole(ranks, name), one(name))


@pytest.mark.parametrize("name", CASES)
def test_2d_copies_bitwise_equal(world2d, name):
    """Every replicated tensor is bitwise equal on the four processes, each
    slice of a split kernel on the two processes of its model index, and every
    metric on all four."""
    _, ranks, _, _ = world2d
    for r in range(1, WORLD):
        a, b = ranks[r % MODEL][name], ranks[r][name]
        ref = ranks[0][name]
        for part in ("generator", "critic", "nu_g", "nu_d", "ema"):
            assert ref[part].keys() == b[part].keys(), part
            for k in ref[part]:
                want = a[part][k] if (part in ("critic", "nu_d") and k in SPLIT) \
                    else ref[part][k]
                assert torch.equal(b[part][k], want), f"rank {r} {part} {k}"
        for sa, sb in zip(ref["steps"], b["steps"]):
            assert sa["metrics"] == sb["metrics"]


# ---------------------------------------------------------------------------
# against the JAX package's 2 x 2 step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_2d(jax_init, world2d):
    """The JAX package's 2 x 2 step (tensor parallelism from its
    ``state_shardings``, H split over ``model``) over the plan's ``jax``
    steps, with the port's fused draws rebuilt and injected."""
    cfg, jstate, state = jax_init
    plan, ranks, _, _ = world2d
    jcfg = _jax_cfg(cfg)
    mesh = jmake_mesh(num_data=2, num_model=2, devices=jax.devices()[:4])
    spec = jstate_shardings(jstate, mesh)
    bsh, rep = jbatch_sharding(mesh, spatial_axis="model"), jreplicated(mesh)
    js, out = jshard_state(jstate, mesh), []
    for (do_g, batch, _, inj), rec in zip(plan["jax"]["steps"], ranks[0]["jax"]["steps"]):
        step = jstep_mod.make_train_step(jcfg, do_g, inject=_to_jax_inject({**inj,
                                                                           **rec["draws"]}))
        jstep = jax.jit(lambda s, b, k, step=step: step(s, b, k),
                        in_shardings=(spec, bsh, rep), out_shardings=(spec, rep))
        js, jm = jstep(js, jax.device_put(jnp.asarray(batch.numpy()), bsh),
                       jax.device_put(jax.random.key(1), rep))
        out.append({k: float(v) for k, v in jm.items()})
    final = {"generator": from_jax_variables({"params": js.g_params, "batch_stats": js.g_stats}),
             "critic": from_jax_variables({"params": js.d_params, "batch_stats": js.d_stats,
                                           "spectral": js.d_spectral},
                                          state.critic.pool_shape)}
    return out, final


@pytest.mark.parametrize("i", range(len(STEPS)))
def test_2d_step_matches_jax_2d_step(world2d, jax_2d, i):
    _, ranks, _, _ = world2d
    got, want = ranks[0]["jax"]["steps"][i]["metrics"], jax_2d[0][i]
    assert set(got) == set(want)
    for k, w in want.items():
        _close(got[k], w, f"metric {k}", 2e-3, 1e-5)


def test_2d_state_matches_jax_2d_state(world2d, jax_2d):
    """Parameters at tests/test_parallel.py's bounds; BN statistics and
    spectral vectors at tests/test_torch_parallel.py's bounds against JAX."""
    _, ranks, _, _ = world2d
    port = _whole(ranks, "jax")
    for net in ("generator", "critic"):
        for k, w in jax_2d[1][net].items():
            got = port[net][k]
            if k.endswith(("running_mean", "running_var")):
                _close(got, w, f"{net} {k}", 1e-4, 1e-4)
            elif k.endswith(("weight_u", "weight_v")):
                _close(got, w, f"{net} {k}", 0.0, 1e-3)
            elif not k.endswith("num_batches_tracked"):
                _close(got, w, f"{net} {k}", 2e-3, 5e-4)


# ---------------------------------------------------------------------------
# the spatially split forward, the stripe map, the placement, checkpoints
# ---------------------------------------------------------------------------

def test_spatially_sharded_generator_forward_is_exact(world2d):
    """Counterpart of tests/test_parallel.py::test_spatially_sharded_forward_is_exact:
    each process's rows and stripe of the eval-mode reconstruction of a
    (4, 32, 32, 1) batch equal those of the unsplit forward to 1e-5."""
    plan, ranks, one, _ = world2d
    want = one("forward")["forward"]
    for r in range(WORLD):
        d, m = divmod(r, MODEL)
        rows = want[2 * d:2 * d + 2, SIZE * m:SIZE * (m + 1)]
        got = ranks[r]["forward"]["forward"]
        assert got.shape == rows.shape
        np.testing.assert_allclose(got.numpy(), rows.numpy(), atol=1e-5)


@pytest.mark.parametrize("m", [0, 1])
def test_stripe_map_draws_the_slice_of_the_global_draw(m):
    """Rows 1-4's plain versions on process (1, m)'s rows 2-3 and stripe m of a
    (4, 6, 8, 5) global tensor draw, bit for bit, the global draw's slice."""
    replica = Replica(rank=1, world=2, model_rank=m, num_model=2, spatial=True)
    g = torch.Generator().manual_seed(5)
    full = torch.randn((4, 8, 5, 6), generator=g).permute(0, 3, 1, 2)   # NCHW channels_last
    part = fused._channels_last(replica.take(full, 2))
    base, big_l, big_g = replica.index_map(part.shape)
    assert (big_l, big_g) == (4 * 5 * 6, 8 * 5 * 6)
    stripe = (big_l, big_g)
    cut = lambda t: replica.take(t, 2)  # noqa: E731
    assert torch.equal(fused.keep_mask(part, 9, 0.5, base, stripe),
                       cut(fused.keep_mask(full, 9, 0.5)))
    c = full.shape[1]
    mean, var, scale, bias = torch.rand(c), torch.rand(c) + 0.5, torch.rand(c), torch.rand(c)
    args = (mean, var, scale, bias, 9, 0.01, 0.5, 1e-5)
    assert torch.equal(fused.bn_act_dropout_reference(part, *args, base, stripe),
                       cut(fused.bn_act_dropout_reference(full, *args)))
    gy = torch.randn(full.shape, generator=g).contiguous(memory_format=torch.channels_last)
    dx = fused.bn_act_dropout_backward_reference(part, cut(gy), *args, base, stripe)[0]
    assert torch.equal(dx, cut(fused.bn_act_dropout_backward_reference(full, gy, *args)[0]))
    lv = torch.randn(full.shape, generator=g).contiguous(memory_format=torch.channels_last)
    z = fused.reparam_kl_reference(part, cut(lv), 11, base, stripe)[0]
    assert torch.equal(z, cut(fused.reparam_kl_reference(full, lv, 11)[0]))
    d_part = fused.reparam_kl_backward_reference(part, cut(lv), cut(gy), None, 11, base, stripe)
    d_full = fused.reparam_kl_backward_reference(full, lv, gy, None, 11)
    assert all(torch.equal(a, cut(b)) for a, b in zip(d_part, d_full))
    # L = G is the contiguous map: the same bits as no stripe
    assert torch.equal(fused.keep_mask(full, 9, 0.5, 0, (8 * 5 * 6,) * 2),
                       fused.keep_mask(full, 9, 0.5))
    with pytest.raises(ValueError, match="multiples of 4"):
        fused.keep_mask(part, 9, 0.5, base, (6, big_g))


def test_state_shardings_marks_the_head_kernels():
    """On a model axis of 2: the kernels of linear_1-3 (16, 8 and 8 outputs)
    and their RMSprop state, at model index 1's rows; linear_4 (one output),
    the biases and everything else whole."""
    cfg = tiny_cfg()
    cfg = cfg.replace(discriminator=cfg.discriminator.replace(linear_widths=(16, 8, 8)))
    state = vt.create_train_state(cfg, device="cpu")
    step = vt.make_train_step(cfg, True)
    step(state, _batches(1, 30)[0], 1)          # the optimizers' state exists after a step
    spec = state_shardings(state, Mesh(num_data=1, num_model=2, model_rank=1))
    split = {k: v for k, v in spec.items() if v != slice(None)}
    assert set(split) == {f"{p}linear_{j}.weight{s}" for j in (1, 2, 3)
                          for p, s in (("critic.", ""), ("opt_d.", ".square_avg"))}
    assert split["critic.linear_1.weight"] == slice(8, 16)
    assert split["opt_d.linear_3.weight.square_avg"] == slice(4, 8)
    assert all(v == slice(None) for v in state_shardings(state, Mesh(num_data=2)).values())


def test_tp_checkpoint_restores_into_one_process_and_back(world2d):
    """The 2 x 2 run's checkpoint (process 0 wrote it after data row 0
    gathered the split kernels) restores into a one-process state with the
    whole kernels of the run; a one-process checkpoint restored into the 2 x 2
    state gives each process its rows."""
    plan, ranks, _, tmp = world2d
    cfg = vt.Config.from_dict(plan["tps"]["cfg"])
    whole = _whole(ranks, "tps")
    restored = CheckpointManager(str(tmp / "tps")).restore(vt.create_train_state(cfg,
                                                                                 device="cpu"))
    for k, v in restored.critic.state_dict().items():
        assert torch.equal(v, whole["critic"][k]), k
    nu = worker._square_avg(restored.opt_d, restored.critic)
    for k, v in nu.items():
        assert torch.equal(v, whole["nu_d"][k]), k
    saved = torch.load(tmp / "one" / "0.pt", weights_only=True)["critic"]
    for r in range(WORLD):
        m = r % MODEL
        got = ranks[r]["tps"]["loaded"]["critic"]
        for k, w in saved.items():
            want = w.chunk(MODEL)[m] if k in SPLIT else w
            assert torch.equal(got[k], want), f"rank {r} {k}"


@pytest.mark.parametrize("seen", SEEN)
def test_tp_save_follows_process_0_when_one_process_sees_the_file(world2d, seen):
    """Each process of the 2 x 2 run saves into a directory of its own, and at
    the step's path one process alone finds a file. Process 0's view decides
    for the model axis: where only process 1 sees a file, the head's slices
    are gathered and process 0 writes a checkpoint that restores the run's
    critic; where only process 0 sees one, nobody gathers and its file stays.
    Neither run waits in a gather that its partner skipped."""
    plan, ranks, _, tmp = world2d
    mine = tmp / f"{seen}_0" / "0.pt"
    if SEEN[seen] == 0:
        assert mine.read_bytes() == OTHER_FILE
        return
    assert (tmp / f"{seen}_1" / "0.pt").read_bytes() == OTHER_FILE
    cfg = vt.Config.from_dict(plan[seen]["cfg"])
    restored = CheckpointManager(str(tmp / f"{seen}_0")).restore(
        vt.create_train_state(cfg, device="cpu"))
    a, b = (ranks[r][seen]["critic"] for r in ROW0)
    for k, v in restored.critic.state_dict().items():
        assert torch.equal(v, torch.cat([a[k], b[k]]) if k in SPLIT else a[k]), k


def test_a_model_axis_over_a_sub_group(tmp_path):
    """``make_mesh(num_model=2, group=g)`` with g the processes {1, 2} of a
    world of three: every process makes the mesh's groups, process 0 gets no
    mesh, and the 1 x 2 mesh's G+D step (tensor parallelism and H split over
    the model axis) is bitwise the same mesh's over a default group of two."""
    cfg = cfg2d()
    one = vt.create_train_state(cfg, device="cpu")
    free = cfg.replace(loss=cfg.loss.replace(clip_value=None)).to_dict()
    plan = {"tp": {"cfg": free, "init": None, "steps": _injected_steps(one.critic, 27)[:1],
                   "tp": True, "spatial": True}}
    for d in ("sub", "two"):
        (tmp_path / d).mkdir()
    sub = run_world(tmp_path / "sub", plan, world=3, num_model=MODEL, members=(1, 2))
    two = run_world(tmp_path / "two", plan, world=2, num_model=MODEL)
    assert sub[0] == {}
    for got, want in zip(sub[1:], two):
        got, want = got["tp"], want["tp"]
        assert got["steps"][0]["metrics"] == want["steps"][0]["metrics"]
        for net in ("generator", "critic", "nu_d", "ema"):
            assert got[net].keys() == want[net].keys()
            for k, v in want[net].items():
                assert torch.equal(got[net][k], v), (net, k)


def test_cli_train_dp_with_a_model_axis_under_torchrun(tmp_path):
    """``cli train --dp`` of a config with ``parallel.num_model`` 2 over two
    gloo processes started by torchrun: a 1 x 2 mesh, the critic head split
    over the model axis and each process the whole batch. Both finish, and
    the checkpoint process 0 writes restores into a one-process state with the
    whole kernels."""
    from test_torch_cli import tiny_arch

    cfg = tiny_arch(tmp_path)
    cfg = cfg.replace(parallel=cfg.parallel.replace(num_model=2),
                      train=cfg.train.replace(sample_interval=2, log_every=1))
    (tmp_path / "cfg.json").write_text(json.dumps(cfg.to_dict()))
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{os.environ.get('PYTHONPATH', '')}",
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
         "-m", "vaegan_tpu_torch.cli", "train", "--dp", "--config", str(tmp_path / "cfg.json"),
         "--synthetic", "--max-steps", "2", "--checkpoint", str(tmp_path / "ck"),
         "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=RUN_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.count("done: 2 steps") == 2, proc.stdout
    one = cfg.replace(parallel=cfg.parallel.replace(num_model=1))
    state = CheckpointManager(str(tmp_path / "ck")).restore(
        vt.create_train_state(one, device="cpu"))
    assert state.step == 2
    assert state.critic.linear_1.weight.shape == (16, state.critic.linear_1.in_features)
    assert all(torch.isfinite(p).all() for p in state.critic.parameters())


@pytest.mark.parametrize("local,want", [(1, "nccl"), (2, "gloo")])
def test_initialize_takes_gloo_where_processes_share_a_card(monkeypatch, local, want):
    """On a CUDA device the process group is NCCL, unless this host starts more
    processes (``LOCAL_WORLD_SIZE``) than it has cards: NCCL refuses two
    processes on one card, so they take gloo."""
    from vaegan_tpu_torch.parallel import dist

    seen = {}
    monkeypatch.setattr(dist, "local_device", lambda device: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "set_device", lambda dev: None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(dist.td, "init_process_group", lambda **kw: seen.update(kw))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local))
    dist.initialize(init_method="tcp://127.0.0.1:1", world_size=local, rank=0)
    assert seen["backend"] == want
