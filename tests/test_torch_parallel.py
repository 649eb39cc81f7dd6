"""Data-parallel training in the port (``vaegan_tpu_torch.parallel``) on the
CPU: two gloo processes, each started as its own Python process
(``tests/_torch_dp_worker.py``) with a file store in a temporary directory and
a time limit of its own, so that a rank that waits for a missing collective
fails the test instead of hanging the suite.

What is held:

- the two-process step equals the one-process step on the global batch
  (``vt.make_train_step`` / ``make_paper_train_step`` in this process), step
  by step over four steps with dropout p = 0.5 in the generator through the
  fused kernels' plain versions (``use_pallas="all"``, each process drawing
  its slice of the global stream from its index base) and in the critic's
  unfused ``Dropout2d`` (drawn for the global batch, each process taking its
  rows): the notebook scheme (G + GP and critic-only steps), the Larsen scheme,
  ``grad_accum=2`` and ``critic_batching="concat"``. Losses, gradients, the
  RMSprop state, BN running statistics, spectral vectors, the EMA and the
  parameters;
- the parameters (and every other state tensor) are bitwise equal on the two
  processes after those steps;
- the two-process step against the JAX package's data-parallel step (its
  ``make_train_step`` jitted with ``vaegan_tpu/parallel/mesh.py``'s shardings
  over a 2-device mesh of the test process's virtual CPU devices), with the
  port's draws rebuilt and injected into the JAX step;
- global BN statistics from shards with very different statistics, the
  divisibility checks, ``dryrun_multichip(2)`` and ``cli train --dp`` under
  ``torchrun`` on gloo.

Tolerances, two processes against one: both run the same float32 arithmetic
except that a sum over the batch is taken as two half sums added by the
all-reduce, so they part by float32 reassociation, about 1e-7 relative per
sum. Losses and metrics 2e-4 relative + 1e-5 absolute (the JAX-parity tests'
bound, not approached: the largest seen is ~4e-6 relative). Gradients within
1e-4 of each tensor's largest gradient plus 1e-6 of the network's largest.
BN running statistics and spectral vectors 1e-5 absolute + 1e-4 relative.
``sqrt(square_avg)`` 1e-4 relative plus 0.1 of the gradient tolerance.
Parameters and the EMA 1e-5 absolute + 1e-4 relative, except where a recorded
gradient element was within its tolerance of zero at some update: there
RMSprop's first steps move a parameter by about 10 lr sign(g), and a sign at
noise scale is noise, so those elements are held to that update bound (2.5 x
10 lr per update). Spectral vectors 1e-3 absolute: u and v follow W, and
where noise decided the sign of a step of W they follow a W that differs by
that step. Against the JAX package: its tests' own bounds
(``tests/test_torch_train_step.py``), metrics 2e-4 relative + 1e-5, BN
statistics 1e-4, spectral vectors 1e-3, plus, for each metric, twice the
difference between JAX's own one-device and two-device steps on the same
inputs: the penalty sits near ||g|| = 1, where (||g|| - 1)^2 magnifies the
float32 reassociation noise of the input gradients' norms (the variance
E[x^2] - E[x]^2 of a BN input with |mean| >> std cancels), and JAX's two
placements themselves part by ~3.5e-4 relative in the penalty there.
"""

from __future__ import annotations

import functools
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
from vaegan_tpu import interop as jinterop
from vaegan_tpu.config import preset as jpreset
from vaegan_tpu.parallel import batch_sharding as jbatch_sharding
from vaegan_tpu.parallel import make_mesh as jmake_mesh
from vaegan_tpu.parallel import replicated as jreplicated
import vaegan_tpu_torch as vt
from vaegan_tpu_torch.interop import from_jax_variables
from vaegan_tpu_torch.ops.replica import Replica, rank_rows
from vaegan_tpu_torch.parallel import Mesh, make_mesh, make_parallel_train_step
from vaegan_tpu_torch.parallel.train import train_data_parallel

sys.path.insert(0, str(Path(__file__).parent))
import _torch_dp_worker as worker  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).parent / "_torch_dp_worker.py"
SIZE, BATCH, WORLD, LR = 16, 8, 2, 3e-4
G_STEPS = (True, False, True, False)
RUN_TIMEOUT_S = 300


def tiny_cfg(**train) -> vt.Config:
    cfg = vt.preset("notebook")
    return cfg.replace(
        generator=cfg.generator.replace(depth=1, length=1, feature_size=4),
        discriminator=cfg.discriminator.replace(
            num_features_conv1=8, num_blocks=(1, 1), num_strides_res=(1, 2),
            num_features_res=(8, 16), linear_widths=(16, 8)),
        data=cfg.data.replace(image_size=SIZE, batch_size=BATCH),
        optim=cfg.optim.replace(lr=LR),
        train=cfg.train.replace(use_pallas="all", ema_decay=0.999, **train))


def paper_cfg() -> vt.Config:
    cfg = tiny_cfg()
    p = vt.preset("vaegan_paper")
    return cfg.replace(loss=p.loss, optim=p.optim.replace(lr=LR))


def _batches(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.random((BATCH, SIZE, SIZE, 1), dtype=np.float32))
            for _ in range(n)]


def _case(cfg: vt.Config, seed: int, g_steps=G_STEPS, batches=None) -> dict:
    batches = _batches(len(g_steps), seed) if batches is None else batches
    return {"cfg": cfg.to_dict(),
            "steps": [(g, b, 100 + i, None) for i, (g, b) in enumerate(zip(g_steps, batches))]}


def _bn_batch() -> torch.Tensor:
    """A global batch whose two halves have very different statistics."""
    return torch.cat([torch.full((BATCH // 2, SIZE, SIZE, 1), v) for v in (0.1, 0.9)])


PLAN = {
    "notebook": lambda: _case(tiny_cfg(), 1),
    "paper": lambda: _case(paper_cfg(), 2),
    "accum2": lambda: _case(tiny_cfg(grad_accum=2), 3),
    "concat": lambda: _case(tiny_cfg(critic_batching="concat"), 4),
    "bn_global": lambda: _case(tiny_cfg(), 5, (True,), [_bn_batch()]),
}


def run_world(tmp: Path, plan: dict, world: int = WORLD, num_model: int = 1,
              members=()) -> list:
    """Each case of ``plan`` over ``world`` gloo processes (a mesh of
    ``world / num_model`` x ``num_model``; over the group of the global ranks
    ``members`` when given); their results in rank order."""
    torch.save(plan, tmp / "plan.pt")
    env = dict(os.environ, PYTHONPATH=f"{ROOT}{os.pathsep}{os.environ.get('PYTHONPATH', '')}")
    sub = [",".join(str(r) for r in members)] if members else []
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(r), str(world), str(tmp),
                               str(tmp / "plan.pt"), str(tmp / f"rank{r}.pt"),
                               str(num_model), *sub],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=RUN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{logs[r][-4000:]}"
    return [torch.load(tmp / f"rank{r}.pt") for r in range(world)]


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    """The plan over two processes (both ranks' results) and, lazily, over
    one."""
    plan = {name: make() for name, make in PLAN.items()}
    ranks = run_world(tmp_path_factory.mktemp("dp"), plan)
    one = functools.lru_cache(maxsize=None)(lambda name: worker.run(plan[name]))
    return plan, ranks, one


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def _close(got, want, what, rtol, atol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bad = np.abs(got - want) > atol + rtol * np.abs(want)
    assert not bad.any(), (f"{what}: {int(bad.sum())}/{bad.size} out of tolerance, "
                           f"max |diff| {np.abs(got - want).max():.3e}")


def _grad_tol(want: dict) -> dict:
    net = max(float(w.abs().max()) for w in want.values())
    return {k: 1e-4 * float(w.abs().max()) + 1e-6 * net for k, w in want.items()}


def _noisy(ref: dict, upto: int, net: str) -> dict:
    """Per parameter, the elements whose gradient was within its tolerance of
    zero at some update up to step ``upto``."""
    out = {}
    for rec in ref["steps"][:upto + 1]:
        want = rec[f"{net}_grads"]
        if want:
            tol = _grad_tol(want)
            for k, w in want.items():
                out[k] = out.get(k, False) | (w.abs() <= tol[k]).numpy()
    return out


def _updates(ref: dict, net: str) -> int:
    return sum(1 for rec in ref["steps"] if rec[f"{net}_grads"])


def _hold_state(got: dict, ref: dict) -> None:
    """Final state of a two-process run against the one-process run."""
    for net, g in (("generator", "g"), ("critic", "d")):
        noisy, n = _noisy(ref, len(ref["steps"]), g), _updates(ref, g)
        for k, w in ref[net].items():
            v = got[net][k]
            if k.endswith("num_batches_tracked"):
                continue
            if k.endswith(("running_mean", "running_var")):
                _close(v, w, f"{net} {k}", 1e-4, 1e-5)
                continue
            if k.endswith(("weight_u", "weight_v")):
                _close(v, w, f"{net} {k}", 0.0, 1e-3)
                continue
            tol = 1e-5 + 1e-4 * np.abs(w.numpy())
            tol = np.where(noisy[k], np.maximum(tol, 2.5 * 10 * LR * n), tol)
            diff = np.abs(v.numpy() - w.numpy())
            assert (diff <= tol).all(), f"{net} {k}: max |diff| {diff.max():.3e}"
        gtol = {}
        for rec in ref["steps"]:
            if rec[f"{g}_grads"]:
                for k, t in _grad_tol(rec[f"{g}_grads"]).items():
                    gtol[k] = max(t, gtol.get(k, 0.0))
        for k, w in ref[f"nu_{g}"].items():
            _close(got[f"nu_{g}"][k].sqrt(), w.sqrt(), f"sqrt(square_avg) {g} {k}", 1e-4,
                   0.1 * gtol[k] + 1e-12)
    noisy, n = _noisy(ref, len(ref["steps"]), "g"), _updates(ref, "g")
    for k, w in ref["ema"].items():
        tol = 1e-5 + 1e-4 * np.abs(w.numpy())
        tol = np.where(noisy[k], np.maximum(tol, 2.5 * 10 * LR * n * 1e-3), tol)
        diff = np.abs(got["ema"][k].numpy() - w.numpy())
        assert (diff <= tol).all(), f"ema {k}: max |diff| {diff.max():.3e}"


STEP_CASES = [(name, i) for name in ("notebook", "paper", "accum2", "concat")
              for i in range(len(G_STEPS))]


@pytest.mark.parametrize("name,i", STEP_CASES, ids=[f"{n}-step{i}" for n, i in STEP_CASES])
def test_dp_step_matches_one_process_step(dp_runs, name, i):
    """Metrics and gradients of step i, two processes against one."""
    _, ranks, one = dp_runs
    got, want = ranks[0][name]["steps"][i], one(name)["steps"][i]
    assert set(got["metrics"]) == set(want["metrics"])
    for k, w in want["metrics"].items():
        _close(got["metrics"][k], w, f"metric {k}", 2e-4, 1e-5)
    for net in ("g", "d"):
        w = want[f"{net}_grads"]
        assert bool(got[f"{net}_grads"]) == bool(w), net
        if w:
            tol = _grad_tol(w)
            for k in w:
                _close(got[f"{net}_grads"][k], w[k], f"{net} grad {k}", 0.0, tol[k])


@pytest.mark.parametrize("name", ["notebook", "paper", "accum2", "concat"])
def test_dp_state_matches_one_process_state(dp_runs, name):
    """After four steps: parameters, BN, SN, RMSprop state and EMA."""
    _, ranks, one = dp_runs
    _hold_state(ranks[0][name], one(name))


@pytest.mark.parametrize("name", list(PLAN))
def test_state_bitwise_equal_across_ranks(dp_runs, name):
    _, ranks, _ = dp_runs
    a, b = ranks[0][name], ranks[1][name]
    for part in ("generator", "critic", "nu_g", "nu_d", "ema"):
        assert a[part].keys() == b[part].keys(), part
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), f"{part} {k}"
    for sa, sb in zip(a["steps"], b["steps"]):
        assert sa["metrics"] == sb["metrics"]


def test_batchnorm_stats_are_global(dp_runs):
    """Counterpart of tests/test_parallel.py::test_batchnorm_stats_are_global:
    the two ranks' rows have means 0.1 and 0.9, and the running statistics
    are those of the one-process step on the whole batch, not of either half."""
    _, ranks, one = dp_runs
    got, want = ranks[0]["bn_global"], one("bn_global")
    local = worker.run({**_case(tiny_cfg(), 5, (True,), [_bn_batch()[:BATCH // 2]])})
    for net in ("generator", "critic"):
        for k, w in want[net].items():
            if k.endswith(("running_mean", "running_var")):
                _close(got[net][k], w, f"{net} {k}", 1e-4, 1e-5)
    first = "encoder.encoder.encoder-depth_0-level_0.shortcut.1.running_mean"
    assert not torch.allclose(local["generator"][first], want["generator"][first], atol=1e-3)


def test_dp_results_hold_the_global_draws(dp_runs):
    """Rank 0's record of the fused draws is the one-process step's: the same
    seeds at the global shapes."""
    _, ranks, one = dp_runs
    for got, want in zip(ranks[0]["notebook"]["steps"], one("notebook")["steps"]):
        assert got["draws"].keys() == want["draws"].keys()
        for k, v in want["draws"].items():
            if isinstance(v, dict):
                for m in v:
                    assert torch.equal(got["draws"][k][m], v[m]), m
            else:
                assert torch.equal(got["draws"][k], v), k


# ---------------------------------------------------------------------------
# against the JAX package's data-parallel step
# ---------------------------------------------------------------------------

JAX_STEPS = (True, False)


def _jax_cfgs():
    jcfg = jpreset("notebook")
    jcfg = jcfg.replace(
        generator=jcfg.generator.replace(depth=1, length=1, feature_size=4),
        discriminator=jcfg.discriminator.replace(
            num_features_conv1=8, num_blocks=(1, 1), num_strides_res=(1, 2),
            num_features_res=(8, 16), linear_widths=(16, 8)),
        data=jcfg.data.replace(image_size=SIZE, batch_size=BATCH),
        train=jcfg.train.replace(use_pallas="losses", ema_decay=0.999))
    cfg = vt.Config.from_dict(jcfg.to_dict())
    return jcfg, cfg.replace(train=cfg.train.replace(use_pallas="all"))


def _critic_masks(critic, rng, batch):
    out = {}
    for name, m in critic.named_modules():
        if isinstance(m, vt.models.ResBlockDiscriminator):
            c = m.conv1.weight_orig.shape[0]
            out[f"{name}.dropout"] = torch.from_numpy(rng.random((batch, c, 1, 1)) >= 0.5)
    return out


def _to_jax_inject(inj: dict) -> dict:
    out = {}
    for k, v in inj.items():
        if "masks" in k:
            pairs = [(n, np.asarray(m.numpy(), np.float32)) for n, m in v.items()]
            out[k] = jax.tree.map(jnp.asarray, jinterop.reference_dropout_masks_to_collection(
                pairs, "discriminator" if k.startswith("d_") else "generator"))
        else:
            out[k] = jnp.asarray(np.asarray(v))
    return out


@pytest.fixture(scope="module")
def jax_dp(tmp_path_factory):
    """Two steps of the port's two-process step and of the JAX package's
    2-device data-parallel step from the same weights, the critic's masks and
    the GP alphas drawn here and injected into both, the port's fused draws
    rebuilt and injected into the JAX step."""
    jcfg, cfg = _jax_cfgs()
    jstate = jstate_mod.create_train_state(jcfg, jax.random.key(0))
    state = vt.create_train_state(cfg, device="cpu")
    vt.load_jax_train_state(state, jstate, state.critic.pool_shape)
    rng = np.random.default_rng(11)
    steps = []
    for i, do_g in enumerate(JAX_STEPS):
        inj = {f"d_masks_{k}": _critic_masks(state.critic, rng, BATCH)
               for k in ("real", "fake", "interp") + (("gen",) if do_g else ())}
        inj["alpha"] = torch.from_numpy(rng.random(BATCH).astype(np.float32))
        batch = torch.from_numpy(rng.random((BATCH, SIZE, SIZE, 1), dtype=np.float32))
        steps.append((do_g, batch, 200 + i, inj))
    init = {"generator": state.generator.state_dict(), "critic": state.critic.state_dict()}
    port = run_world(tmp_path_factory.mktemp("jaxdp"),
                     {"jax": {"cfg": cfg.to_dict(), "init": init, "steps": steps}})[0]["jax"]

    out = {}
    for n_dev in (WORLD, 1):
        mesh = jmake_mesh(num_data=n_dev, devices=jax.devices()[:n_dev])
        rep, bsh = jreplicated(mesh), jbatch_sharding(mesh)
        js, out[n_dev] = jstate, []
        for (do_g, batch, _, inj), rec in zip(steps, port["steps"]):
            jinj = _to_jax_inject({**inj, **rec["draws"]})
            step = jstep_mod.make_train_step(jcfg, do_g, inject=jinj)
            jstep = jax.jit(lambda s, b, k, step=step: step(s, b, k),
                            in_shardings=(rep, bsh, rep), out_shardings=(rep, rep))
            js, jm = jstep(js, jax.device_put(jnp.asarray(batch.numpy()), bsh),
                           jax.device_put(jax.random.key(1), rep))
            out[n_dev].append({"metrics": {k: float(v) for k, v in jm.items()},
                               "generator": from_jax_variables({"params": js.g_params,
                                                                "batch_stats": js.g_stats}),
                               "critic": from_jax_variables({"params": js.d_params,
                                                             "batch_stats": js.d_stats,
                                                             "spectral": js.d_spectral},
                                                            state.critic.pool_shape)})
    return port, out[WORLD], out[1]


@pytest.mark.parametrize("i", range(len(JAX_STEPS)))
def test_dp_step_matches_jax_data_parallel_step(jax_dp, i):
    port, jout, jone = jax_dp
    got, want, spread = port["steps"][i]["metrics"], jout[i]["metrics"], jone[i]["metrics"]
    assert set(got) == set(want)
    for k, w in want.items():
        _close(got[k], w, f"metric {k}", 2e-4, 1e-5 + 2 * abs(spread[k] - w))


def test_dp_state_matches_jax_data_parallel_state(jax_dp):
    port, jout, _ = jax_dp
    for net in ("generator", "critic"):
        for k, w in jout[-1][net].items():
            if k.endswith(("running_mean", "running_var")):
                _close(port[net][k], w, f"{net} {k}", 1e-4, 1e-4)
            elif k.endswith(("weight_u", "weight_v")):
                _close(port[net][k], w, f"{net} {k}", 0.0, 1e-3)


# ---------------------------------------------------------------------------
# layout, checks, entry points
# ---------------------------------------------------------------------------

def test_rank_rows_layout_and_the_loader_picks_them():
    assert rank_rows(8, 1, 2).tolist() == [4, 5, 6, 7]
    assert rank_rows(8, 1, 2, microbatches=2).tolist() == [2, 3, 6, 7]
    rows = [rank_rows(8, r, 2, 2) for r in range(2)]
    # microbatch j of the two-process step is the one-process step's rows [4j, 4j + 4)
    for j in range(2):
        assert torch.cat([r.view(2, 2)[j] for r in rows]).tolist() == list(range(4 * j, 4 * j + 4))
    ds = vt.data.pipeline.SyntheticDataset(16, 8)
    whole = vt.data.pipeline.DataLoader(ds, batch_size=8, seed=3, prefetch_batches=0,
                                        drop_last=True)
    for k in (1, 2):
        shards = [vt.data.pipeline.DataLoader(ds, batch_size=8, seed=3, prefetch_batches=0,
                                              process_index=r, process_count=2,
                                              microbatches=k) for r in range(2)]
        for full, *parts in zip(whole, *shards):
            for r, part in enumerate(parts):
                np.testing.assert_array_equal(part, full[rank_rows(8, r, 2, k).numpy()])
        whole = vt.data.pipeline.DataLoader(ds, batch_size=8, seed=3, prefetch_batches=0,
                                            drop_last=True)


def test_replica_draws_and_takes_the_global_rows():
    full = torch.arange(24).view(12, 2)
    assert Replica(1, 2).take(full).tolist() == full[6:].tolist()
    # two concatenated batches of 6 rows: this rank's rows of each
    assert Replica(1, 2).concat(2).take(full).flatten().tolist() == \
        torch.cat([full[3:6], full[9:12]]).flatten().tolist()
    g = torch.Generator().manual_seed(0)
    whole = torch.rand((8, 3), generator=torch.Generator().manual_seed(0))
    assert torch.equal(Replica(1, 2).draw((4, 3), lambda s: torch.rand(s, generator=g)),
                       whole[4:])
    # rank 1's first element of a (2, 3, 2, 2) global tensor: whole images, L = G
    assert Replica(1, 2).index_map((1, 3, 2, 2)) == (12, 12, 12)
    with pytest.raises(ValueError, match="multiple of 4"):
        Replica(1, 2).index_map((1, 3, 1, 2))


def test_batch_not_divisible_raises(tmp_path):
    cfg = tiny_cfg()
    cfg = cfg.replace(data=cfg.data.replace(batch_size=6, synthetic=True),
                      train=cfg.train.replace(grad_accum=2))
    with pytest.raises(ValueError, match="divisible"):
        train_data_parallel(cfg, mesh=Mesh(num_data=2), device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        rank_rows(6, 0, 4)


def test_mesh_refuses_what_it_cannot_place():
    """A mesh that is not the world, a stripe count that does not divide a
    stage's H, a kernel whose output width the model axis does not divide,
    an axis the mesh does not have, and a penalty-less paper step."""
    from vaegan_tpu_torch.parallel import BatchSpec, batch_sharding

    with pytest.raises(ValueError, match="processes"):
        make_mesh(num_data=1, num_model=2)
    with pytest.raises(ValueError, match="processes"):
        make_mesh(num_data=2)
    mesh = make_mesh()
    assert mesh.num_data == 1 and mesh.rank == 0 and not mesh.replica.parallel
    assert mesh.shape == {"data": 1, "model": 1}
    with pytest.raises(ValueError, match="meaningless"):
        make_parallel_train_step(paper_cfg(), mesh, do_gp=False)
    with pytest.raises(ValueError, match="second axis"):
        batch_sharding(mesh, spatial_axis="spatial")
    # three stripes divide no stage of a 16-row image; two do, but not the
    # critic's avg-pool of a 16-row map by 8
    three = Mesh(num_data=1, num_model=3)
    with pytest.raises(ValueError, match="encoder-depth_0"):
        make_parallel_train_step(tiny_cfg(), three, batch_spec=BatchSpec(spatial=True))
    cfg = tiny_cfg()
    cfg = cfg.replace(discriminator=cfg.discriminator.replace(num_strides_res=(1, 1),
                                                              pool_size=16))
    with pytest.raises(ValueError, match="avg-pool"):
        make_parallel_train_step(cfg, Mesh(num_data=1, num_model=2),
                                 batch_spec=BatchSpec(spatial=True))
    # a kernel of 8 outputs splits over 2 or 4 processes, not over 3
    lin = vt.models.layers.Linear(4, 8)
    assert lin.rows(1, 4) == slice(2, 4)
    with pytest.raises(ValueError, match="cannot be split"):
        lin.rows(0, 3)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_two_processes(capfd, n):
    """Two processes: data 2 x model 1. Four: the JAX dry run's data 2 x
    model 2 mesh with the critic head split and H split over the model axis."""
    from vaegan_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(n)
    out = capfd.readouterr().out
    assert f"dryrun_multichip({n}) ok" in out, out
    if n == 4:
        assert "mesh data=2 x model=2, dp + critic-head tp + spatial sharding" in out, out


def test_cli_train_dp_under_torchrun(tmp_path):
    """``cli train --dp`` over two gloo processes started by torchrun: both
    finish their steps and rank 0 writes the checkpoint."""
    from test_torch_cli import tiny_arch

    cfg = tiny_arch(tmp_path)
    cfg = cfg.replace(train=cfg.train.replace(sample_interval=2, log_every=1))
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
    assert proc.stdout.count("[Epoch 0/") == 2, proc.stdout   # rank 0's sink only
    assert (tmp_path / "ck" / "2.pt").exists()
    assert sorted(p.name for p in (tmp_path / "samples").iterdir()) == ["0.png"]


def test_entry_points_default_to_cuda():
    """The new entry points run on ``cuda`` unless asked for the CPU, and
    raise without CUDA (before any process group starts)."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without CUDA")
    from vaegan_tpu_torch.parallel import dist

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dist.initialize()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_data_parallel(tiny_cfg())
    assert not dist.is_initialized()


def test_bf16_fused_recon_takes_the_batch_in_float32():
    """A bfloat16 step's reconstruction against its float32 batch: both taken
    in float32, as the JAX package's recon_loss_sums casts each (the sums and
    the reconstruction's gradient equal JAX's within 1e-6 relative)."""
    from vaegan_tpu.ops.pallas_fused import recon_loss_sums as jrecon

    from vaegan_tpu_torch.ops import fused

    rng = np.random.default_rng(3)
    r = rng.standard_normal((2, 16, 16, 1)).astype(np.float32)
    t = rng.random((2, 16, 16, 1), dtype=np.float32)
    rb = torch.from_numpy(r).to(torch.bfloat16).requires_grad_(True)
    sums = fused.recon_loss_sums(rb, torch.from_numpy(t))
    (sums[0] + 2 * sums[1]).backward()
    jr = jnp.asarray(r).astype(jnp.bfloat16)
    want, vjp = jax.vjp(lambda a: jrecon(a, jnp.asarray(t)), jr)
    (jgrad,) = vjp(jnp.asarray([1.0, 2.0], jnp.float32))
    np.testing.assert_allclose(sums.detach().numpy(), np.asarray(want), rtol=1e-6)
    assert rb.grad.dtype == torch.bfloat16
    np.testing.assert_array_equal(rb.grad.float().numpy(), np.asarray(jgrad.astype(jnp.float32)))
