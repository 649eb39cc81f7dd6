"""Reading the JAX package's Orbax checkpoints in the port (``orbax_reader``,
``checkpoint.CheckpointManager``), held against ``orbax`` itself and against
TensorStore's OCDBT key-value store, which only these tests import.

States: the committed fixtures of ``tests/data/orbax/`` (two steps of the JAX
loop: ``rmsprop_ema``, the notebook's two-optimizer RMSprop with an EMA;
``three``, the three-optimizer scheme; ``tests/make_orbax_fixtures.py`` writes
them), and states the JAX package's ``CheckpointManager`` writes here with
seeded noise on every float leaf: two-optimizer RMSprop without an EMA, Adam
with decoupled weight decay (an optax chain) and the three-optimizer scheme. No
config has a bfloat16 leaf (parameters and optimizer state stay float32), so a
bfloat16 zarr array is written with TensorStore.

Every leaf read by the port is bitwise ``orbax``'s restore. The step after a
restore is held to ``tests/test_torch_train_step.py``'s tolerances.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import make_orbax_fixtures as fixtures
import vaegan_tpu.train.state as jstate_mod
import vaegan_tpu.train.step as jstep_mod
from vaegan_tpu.checkpoint import CheckpointManager as JaxCheckpointManager
import vaegan_tpu_torch as vt
from vaegan_tpu_torch import orbax_reader
from vaegan_tpu_torch.checkpoint import CheckpointManager
from vaegan_tpu_torch.interop import from_jax_variables
from vaegan_tpu_torch.train import make_train_step
from test_torch_train_step import (BATCH, SIZE, GradRec, _close, _gen_mask_shapes, _grad_tol,
                                   _masks_collection, _numpy_critic_masks, _params_tree,
                                   _record_port, _recording)

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
COMMITTED = ROOT / "tests" / "data" / "orbax"
WRITTEN = ("rmsprop", "adam", "three_fresh")
CASES = fixtures.FIXTURES + WRITTEN


def jax_config(case: str):
    """The JAX config of a case: a committed fixture's, or a variant of one."""
    if case in fixtures.FIXTURES:
        return fixtures.config(case)
    base = fixtures.config("three" if case == "three_fresh" else "rmsprop_ema")
    train = base.train.replace(ema_decay=None)
    optim = (base.optim.replace(optimizer="adam", weight_decay=1e-4) if case == "adam"
             else base.optim)
    return base.replace(train=train, optim=optim)


def port_config(case: str, mode: str = "off") -> vt.Config:
    cfg = vt.Config.from_dict(jax_config(case).to_dict())
    return cfg.replace(train=cfg.train.replace(use_pallas=mode))


def noisy(state, seed: int):
    """``state`` with seeded noise on every float leaf (non-negative where the
    leaf was: RMSprop's and Adam's second moments), the integers kept."""
    rng = np.random.default_rng(seed)

    def bump(a):
        a = np.asarray(a)
        if a.dtype.kind != "f":
            return jnp.asarray(a)
        z = rng.standard_normal(a.shape).astype(a.dtype)
        return jnp.asarray(np.abs(a + z) if (a >= 0).all() else a + z)

    return jax.tree.map(bump, state)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """{case: checkpoint directory}: copies of the committed fixtures (orbax
    must not touch the committed files) and the states written here."""
    tmp = tmp_path_factory.mktemp("orbax")
    out = {}
    for name in fixtures.FIXTURES:
        out[name] = tmp / name
        shutil.copytree(COMMITTED / name / "checkpoint", out[name])
    for i, case in enumerate(WRITTEN):
        state = noisy(jstate_mod.create_train_state(jax_config(case), jax.random.key(i)), i)
        out[case] = tmp / case
        mgr = JaxCheckpointManager(str(out[case]))
        mgr.save(state.replace(step=jnp.asarray(3 + i, jnp.int32)))
        mgr.wait()
        mgr.close()
    return out


def step_dir(directory: Path) -> str:
    steps = [p for p in directory.iterdir() if p.name.isdigit()]
    assert len(steps) == 1
    return str(steps[0])


def flat(tree, path=()):
    """{key path: leaf} of a tree of mappings and sequences."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, path + (str(k),)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(flat(v, path + (str(i),)))
        return out
    return {path: tree}


# ---------------------------------------------------------------- the reader
@pytest.mark.parametrize("case", CASES)
def test_every_leaf_is_orbax_restore_bitwise(store, case):
    want = flat(fixtures.restore_raw(str(store[case])))
    got = flat(orbax_reader.read_tree(step_dir(store[case])))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        if w is None:
            assert g is None, path
            continue
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, path
        assert g.tobytes() == w.tobytes(), path


@pytest.mark.parametrize("case", CASES)
def test_keys_and_values_are_tensorstores(store, case):
    import tensorstore as ts

    directory = os.path.join(step_dir(store[case]), "default")
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{directory}"}).result()
    keys = sorted(k.decode() for k in kv.list().result())
    ours = orbax_reader.OcdbtStore(directory)
    assert ours.keys() == keys
    for k in keys:
        assert ours[k] == kv.read(k).result().value, k


@pytest.mark.parametrize("name", fixtures.FIXTURES)
def test_committed_fixtures_are_a_fresh_orbax_restore(store, name):
    """leaves.json, the sha256 of each leaf as orbax restored it when the
    fixture was written, is orbax's restore now and the port reader's."""
    recorded = {tuple(r["path"]): r for r in
                json.loads((COMMITTED / name / "leaves.json").read_text())}
    fresh = {tuple(r["path"]): r for r in
             fixtures.leaves(fixtures.restore_raw(str(store[name])))}
    assert fresh == recorded
    for path, leaf in flat(orbax_reader.read_tree(step_dir(store[name]))).items():
        r = recorded[path]
        if leaf is None:
            assert r["sha256"] is None
            continue
        assert [str(leaf.dtype), list(leaf.shape)] == [r["dtype"], r["shape"]], path
        assert hashlib.sha256(np.asarray(leaf).tobytes()).hexdigest() == r["sha256"]


def test_a_tree_of_interior_nodes_and_chunked_arrays(tmp_path):
    """TensorStore writes zarr v2 arrays (float32 split into chunks with ragged
    edges, bfloat16, an int32 scalar) into an OCDBT store whose nodes hold a few
    hundred bytes (a B-tree of several levels) and whose values above 16 bytes
    go to data files; the reader gives them back exactly."""
    import tensorstore as ts

    base = {"driver": "ocdbt", "base": f"file://{tmp_path}",
            "config": {"max_decoded_node_bytes": 400, "max_inline_value_bytes": 16}}
    rng = np.random.default_rng(0)
    arrays = {"a.f32": rng.standard_normal((5, 7)).astype(np.float32),
              "b.bf16": rng.standard_normal((9, 4)).astype(jnp.bfloat16),
              "c.i32": np.asarray(7, np.int32)}
    chunks = {"a.f32": [2, 3], "b.bf16": [4, 4], "c.i32": []}
    for key, a in arrays.items():
        dtype = "bfloat16" if key.endswith("bf16") else a.dtype.str
        t = ts.open({"driver": "zarr", "kvstore": {**base, "path": key},
                     "metadata": {"shape": list(a.shape), "chunks": chunks[key], "dtype": dtype,
                                  "compressor": {"id": "zstd", "level": 1}}},
                    create=True).result()
        t.write(a).result()
    kv = ts.KvStore.open(base).result()
    for i in range(60):
        kv.write(f"k{i:03d}", bytes([i]) * (i % 40)).result()
    ours = orbax_reader.OcdbtStore(str(tmp_path))
    assert ours.height >= 2
    assert ours.keys() == sorted(k.decode() for k in kv.list().result())
    for k in ours.keys():
        assert ours[k] == kv.read(k).result().value, k
    np.testing.assert_array_equal(orbax_reader.read_array(ours, "a.f32"), arrays["a.f32"])
    np.testing.assert_array_equal(orbax_reader.read_array(ours, "c.i32"), arrays["c.i32"])
    got = orbax_reader.read_array(ours, "b.bf16")
    assert got.dtype == torch.bfloat16
    assert got.view(torch.int16).numpy().tobytes() == arrays["b.bf16"].tobytes()


def test_zstd_frames_with_and_without_their_size():
    """One ``ZSTD_decompress`` call where the frame states its size, the stream
    where it does not or where several frames follow one another, against the
    ``zstandard`` package."""
    import zstandard

    rng = np.random.default_rng(1)
    data = rng.integers(0, 4, 3 << 20, dtype=np.uint8).tobytes()    # > one output chunk
    sized = zstandard.ZstdCompressor().compress(data)
    unsized = zstandard.ZstdCompressor(write_content_size=False).compress(data)
    assert zstandard.get_frame_parameters(unsized).content_size == zstandard.CONTENTSIZE_UNKNOWN
    for frame in (sized, unsized):
        assert orbax_reader.zstd_decompress(frame) == data
    two = zstandard.ZstdCompressor().compress(b"abc") + sized
    assert orbax_reader.zstd_decompress(two) == b"abc" + data
    for frame, want in ((sized, data), (unsized, data), (two, b"abc" + data)):   # in place
        into = np.empty(len(want), np.uint8)
        assert orbax_reader.zstd_decompress(frame, into) is into and into.tobytes() == want
    for frame in (sized, unsized):
        for n in (len(data) - 1, len(data) + 1):
            with pytest.raises(ValueError, match="zstd: the frames hold"):
                orbax_reader.zstd_decompress(frame, np.empty(n, np.uint8))
    with pytest.raises(ValueError, match="zstd"):
        orbax_reader.zstd_decompress(unsized[:len(unsized) // 2])
    with pytest.raises(ValueError, match="zstd"):
        orbax_reader.zstd_decompress(b"not zstd at all")


def test_a_missing_zstd_library_raises_naming_it(monkeypatch):
    def refuse(name, *a, **k):
        raise OSError(f"{name}: cannot open shared object file")

    monkeypatch.setattr(orbax_reader, "_LIB", None)
    monkeypatch.setattr(orbax_reader.ctypes.util, "find_library", lambda name: None)
    monkeypatch.setattr(orbax_reader.ctypes, "CDLL", refuse)
    with pytest.raises(RuntimeError, match="libzstd.so.1"):
        orbax_reader.zstd_decompress(b"\x28\xb5\x2f\xfd")


def test_a_corrupt_node_fails_its_checksum(store, tmp_path):
    copy = tmp_path / "ck"
    shutil.copytree(store["rmsprop_ema"], copy)
    manifest = Path(step_dir(copy)) / "default" / "manifest.ocdbt"
    raw = bytearray(manifest.read_bytes())
    raw[20] ^= 0xFF
    manifest.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="CRC-32C"):
        orbax_reader.read_tree(step_dir(copy))


# ---------------------------------------------------------------- the manager
def test_saved_has_g_ema_is_tri_state(store, tmp_path):
    """True, False, and None for a ``_METADATA`` that cannot be read, as
    tests/test_loop_and_inference.py has it for the JAX package."""
    assert CheckpointManager(str(store["rmsprop_ema"])).saved_has_g_ema() is True
    assert CheckpointManager(str(store["three"])).saved_has_g_ema() is False
    copy = tmp_path / "ck"
    shutil.copytree(store["rmsprop_ema"], copy)
    (Path(step_dir(copy)) / "default" / "_METADATA").write_text("{not json")
    assert CheckpointManager(str(copy)).saved_has_g_ema() is None


def test_an_unfinished_orbax_save_is_not_a_step(store, tmp_path):
    copy = tmp_path / "ck"
    shutil.copytree(store["rmsprop_ema"], copy)
    shutil.copytree(step_dir(copy), copy / "5.orbax-checkpoint-tmp-1792272806")
    mgr = CheckpointManager(str(copy))
    assert mgr.all_steps() == [2] and mgr.latest_step() == 2


def jax_restored(case: str, directory: Path):
    """The JAX state of ``directory``, restored by the JAX package into its own
    template (namedtuple optimizer states)."""
    template = jstate_mod.create_train_state(jax_config(case), jax.random.key(0))
    mgr = JaxCheckpointManager(str(directory))
    try:
        return mgr.restore(template)
    finally:
        mgr.close()


def state_tensors(state) -> dict:
    out = {f"generator.{k}": v for k, v in state.generator.state_dict().items()}
    out.update({f"critic.{k}": v for k, v in state.critic.state_dict().items()})
    for opt in ("opt_g", "opt_d"):
        for i, st in getattr(state, opt).state_dict()["state"].items():
            out.update({f"{opt}.{i}.{k}": v for k, v in st.items()})
    out.update({f"g_metrics.{k}": v for k, v in state.g_metrics.items()})
    out.update({f"g_ema.{k}": v for k, v in (state.g_ema or {}).items()})
    return out


@pytest.mark.parametrize("case", CASES)
def test_restore_is_load_jax_train_state(store, case, tmp_path):
    """``restore`` of an Orbax step (mappings and lists read from disk) gives
    bitwise the state that ``load_jax_train_state`` makes of the JAX package's
    own restore (namedtuples): RMSprop, Adam after ``add_decayed_weights``, the
    three-optimizer ``{"enc", "dec"}``, with and without an EMA."""
    cfg = port_config(case)
    mgr = CheckpointManager(str(store[case]))
    got = mgr.restore(vt.create_train_state(cfg, device="cpu", seed=1))
    want = vt.create_train_state(cfg, device="cpu", seed=2)
    vt.load_jax_train_state(want, jax_restored(case, store[case]), want.critic.pool_shape)
    assert got.step == want.step == int(mgr.latest_step())
    a, b = state_tensors(got), state_tensors(want)
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert (got.g_ema is None) == (case != "rmsprop_ema")


@pytest.mark.filterwarnings("ignore:for .*copying from a non-meta parameter")
def test_restore_puts_every_tensor_on_the_templates_device(store):
    """A template on another device than the CPU (``meta`` here, the card in
    use) gets the Orbax step's EMA, metrics and optimizer state there too."""
    state = CheckpointManager(str(store["rmsprop_ema"])).restore(
        vt.create_train_state(port_config("rmsprop_ema"), device="meta"))
    for k, v in state_tensors(state).items():
        assert v.device.type == "meta" or k.endswith(".step"), k


def test_restore_then_a_step_matches_the_jax_step(store):
    """One G+D step of each package from the ``rmsprop_ema`` fixture (the port's
    restored by ``CheckpointManager``, JAX's by orbax), unfused on both sides
    with the draws injected into both: metrics and gradients at
    tests/test_torch_train_step.py's tolerances, the EMA at 1e-4 relative."""
    case = "rmsprop_ema"
    jcfg = jax_config(case).replace(train=jax_config(case).train.replace(use_pallas="off"))
    cfg = port_config(case)
    assert (cfg.data.image_size, cfg.data.batch_size) == (SIZE, BATCH)
    js = jax_restored(case, store[case])
    js = js.replace(opt_g=GradRec(js.opt_g, jax.tree.map(jnp.zeros_like, js.g_params)),
                    opt_d=GradRec(js.opt_d, jax.tree.map(jnp.zeros_like, js.d_params)))
    mp = pytest.MonkeyPatch()
    orig = jstep_mod.build_optimizer
    mp.setattr(jstep_mod, "build_optimizer", lambda c, role=None: _recording(orig(c, role)))
    try:
        jstep = jax.jit(lambda s, b, inj: jstep_mod.make_train_step(jcfg, True, inject=inj)(
            s, b, jax.random.key(1)))
        state = CheckpointManager(str(store[case])).restore(
            vt.create_train_state(cfg, device="cpu"))
        pool = state.critic.pool_shape
        g_rec, d_rec = {}, {}
        _record_port(state.opt_g, state.generator, g_rec)
        _record_port(state.opt_d, state.critic, d_rec)
        rng = np.random.default_rng(7)
        batch = rng.random((BATCH, SIZE, SIZE, 1), dtype=np.float32)
        inj = {f"d_masks_{k}": _numpy_critic_masks(state.critic, rng)
               for k in ("real", "fake", "interp", "gen")}
        inj["alpha"] = torch.from_numpy(rng.random(BATCH).astype(np.float32))
        inj["eps"] = torch.from_numpy(
            rng.standard_normal((BATCH, SIZE // 2, SIZE // 2, 8)).astype(np.float32))
        inj["g_masks"] = {name: torch.from_numpy(rng.random(shape) >= 0.5)
                          for name, shape in _gen_mask_shapes(state.generator)}
        state, metrics = make_train_step(cfg, True, inject=inj)(state, torch.from_numpy(batch), 9)
        jinj = {k: (_masks_collection(v, "discriminator" if k.startswith("d_") else "generator")
                    if "masks" in k else jnp.asarray(np.asarray(v))) for k, v in inj.items()}
        js, jmetrics = jstep(js, jnp.asarray(batch), jinj)
    finally:
        mp.undo()
    assert set(metrics) == set(jmetrics)
    for k, want in jmetrics.items():
        _close(float(metrics[k]), float(want), f"metric {k}", 2e-4, 1e-5)
    for got, want, what, share in (
            (g_rec, from_jax_variables({"params": js.opt_g.grads}), "generator", 1e-5),
            (d_rec, _params_tree(js.opt_d.grads, js.d_spectral, pool), "critic", 1e-2)):
        assert set(got) == set(want)
        tol = _grad_tol(want, share)
        for k, w in want.items():
            _close(got[k].numpy(), w.numpy(), f"{what} grad {k}", 0.0, tol[k])
    jema = from_jax_variables({"params": js.g_ema})
    for k, w in jema.items():
        _close(state.g_ema[k].numpy(), w.numpy(), f"ema {k}", 1e-4, 1e-7)


def test_a_mixed_directory_lists_and_prunes(store, tmp_path):
    """The port's saves land beside an Orbax step as ``<step>.pt``; pruning to
    ``max_to_keep`` removes only those, and the Orbax step is still read."""
    copy = tmp_path / "ck"
    shutil.copytree(store["rmsprop_ema"], copy)
    mgr = CheckpointManager(str(copy), max_to_keep=2)
    state = mgr.restore(vt.create_train_state(port_config("rmsprop_ema"), device="cpu"))
    for step in (3, 4, 5):
        mgr.save(state.replace(step=step))
    assert mgr.all_steps() == [2, 4, 5] and mgr.latest_step() == 5
    assert sorted(p.name for p in copy.iterdir()) == ["2", "4.pt", "5.pt"]
    again = mgr.restore(vt.create_train_state(port_config("rmsprop_ema"), device="cpu"), step=2)
    assert all(torch.equal(a, b) for a, b in zip(state_tensors(again).values(),
                                                  state_tensors(state).values()))


def test_a_tensor_parallel_template_gets_its_rows(store):
    """A template whose critic head holds rows (1 of 2) of ``linear_1`` gets
    those rows of the Orbax state's kernel and of its RMSprop state."""
    cfg = port_config("rmsprop_ema")
    mgr = CheckpointManager(str(store["rmsprop_ema"]))
    whole = mgr.restore(vt.create_train_state(cfg, device="cpu"))
    part = vt.create_train_state(cfg, device="cpu")
    layer = part.critic.linear_1
    layer.shard(1, 2, part.opt_d)
    part = mgr.restore(part)
    rows = layer.rows(1, 2)
    want = whole.critic.linear_1.weight
    assert torch.equal(layer.weight, want[rows])
    assert torch.equal(part.opt_d.state[layer.weight]["square_avg"],
                       whole.opt_d.state[want]["square_avg"][rows])


def test_train_resumes_an_orbax_directory(store, tmp_path):
    """``train(cfg, resume=True)`` on a copy of the ``rmsprop_ema`` fixture
    continues from its step 2 for 2 more steps and saves ``4.pt`` beside it."""
    copy = tmp_path / "ck"
    shutil.copytree(store["rmsprop_ema"], copy)
    cfg = port_config("rmsprop_ema", "all")
    cfg = cfg.replace(train=cfg.train.replace(n_epochs=2, checkpoint_dir=str(copy),
                                              sample_dir=str(tmp_path / "samples")))
    state, _ = vt.train(cfg, resume=True, device="cpu")
    assert state.step == 4
    mgr = CheckpointManager(str(copy))
    assert mgr.all_steps() == [2, 4] and (copy / "4.pt").exists() and (copy / "2").is_dir()


def test_cli_samples_from_an_orbax_directory(store, tmp_path):
    from vaegan_tpu_torch import cli

    out = tmp_path / "s.png"
    assert cli.main(["sample", "--config", str(COMMITTED / "three" / "config.json"),
                     "--checkpoint", str(store["three"]), "--device", "cpu",
                     "-n", "4", "-o", str(out)]) == 0
    assert out.stat().st_size > 0


# the port's read of a step directory, in a process that imports neither JAX nor
# this file: the read's wall, the process's peak RSS and each leaf's sha256
FULL_READ = """
import hashlib, json, sys, time
import numpy as np
from vaegan_tpu_torch import orbax_reader
def flat(t, p=()):
    if isinstance(t, dict):
        return {k2: v2 for k, v in t.items() for k2, v2 in flat(v, p + (str(k),)).items()}
    if isinstance(t, list):
        return {k2: v2 for i, v in enumerate(t) for k2, v2 in flat(v, p + (str(i),)).items()}
    return {p: t}
t = time.perf_counter()
tree = orbax_reader.read_tree(sys.argv[1])
wall = time.perf_counter() - t
# the process's own high-water mark, before the hashing (getrusage's would carry
# the parent's across fork and exec)
peak = int(open("/proc/self/status").read().split("VmHWM:")[1].split()[0]) / 1024
sums = {"/".join(k): hashlib.sha256(np.asarray(v).tobytes()).hexdigest()
        for k, v in flat(tree).items() if v is not None}
print(json.dumps({"wall_s": wall, "sums": sums, "peak_rss_mib": peak}))
"""


@pytest.mark.skipif(os.environ.get("ORBAX_FULL") != "1",
                    reason="set ORBAX_FULL=1: writes the notebook preset's full TrainState "
                           "(~1.2 GB) with JAX and reads it with the port")
def test_full_width_notebook_state(tmp_path):
    """The notebook preset's full TrainState (4.19 M generator and 139.7 M
    critic parameters, RMSprop), written by the JAX package, read by the port
    in a process of its own: every leaf bitwise orbax's; prints the read's wall
    time and the process's peak RSS."""
    from vaegan_tpu.config import preset

    state = jstate_mod.create_train_state(preset("notebook"), jax.random.key(0))
    mgr = JaxCheckpointManager(str(tmp_path / "ck"))
    mgr.save(state)
    mgr.wait()
    mgr.close()
    want = {k: hashlib.sha256(np.asarray(v).tobytes()).hexdigest()
            for k, v in flat(fixtures.restore_raw(str(tmp_path / "ck"))).items()
            if v is not None}
    del state
    t = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", FULL_READ, step_dir(tmp_path / "ck")], cwd=ROOT,
                         capture_output=True, text=True, timeout=1800)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["sums"] == {"/".join(k): v for k, v in want.items()}
    print(f"\nfull-width notebook TrainState read by the port: {got['wall_s']:.2f} s, peak RSS "
          f"{got['peak_rss_mib']:.0f} MiB (process {time.perf_counter() - t:.1f} s)")
