"""The port's data feed against the JAX package's (``vaegan_tpu/data``).

Datasets and loaders are numpy on both sides, so the checks are bitwise: the
synthetic images of every style and seed, the host loader's batches over two
epochs (shuffle, ``drop_last``, resume hooks, process sharding, prefetch), the
decode cache, the Python NIfTI decoder. The native decoder is built by the port
from the same C++ source without ``-march=native``, so it is held to the Python
decoder within 1e-6 (absolute, on images in [0, 1]) rather than bitwise. The
device loader and ``device_prefetch`` run here on the CPU.
"""

from __future__ import annotations

import warnings
import zipfile

import numpy as np
import pytest
import torch

from vaegan_tpu.data import fetch as jfetch
from vaegan_tpu.data import nifti as jnifti
from vaegan_tpu.data import pipeline as jpipe
from vaegan_tpu_torch.config import DataConfig
from vaegan_tpu_torch.data import fetch, nifti, pipeline

# the suite runs files in parallel workers; one intra-op thread each keeps
# torch from taking every core from the other workers
torch.set_num_threads(1)


def batches(loader, epochs=2):
    return [np.asarray(b) for _ in range(epochs) for b in loader]


def assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("style", ["blobs", "edges", "texture"])
def test_synthetic_images_match_jax_bitwise(style, seed):
    port = pipeline.SyntheticDataset(6, 20, seed=seed, style=style).load_batch(range(6))
    ref = jpipe.SyntheticDataset(6, 20, seed=seed, style=style).load_batch(range(6))
    assert port.dtype == np.float32 and port.shape == (6, 20, 20, 1)
    np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("drop_last", [False, True])
@pytest.mark.parametrize("shuffle", [True, False])
def test_host_loader_matches_jax_over_two_epochs(shuffle, drop_last, prefetch):
    kw = dict(batch_size=4, shuffle=shuffle, drop_last=drop_last, seed=5,
              prefetch_batches=prefetch)
    port = pipeline.DataLoader(pipeline.SyntheticDataset(10, 8), **kw)
    ref = jpipe.DataLoader(jpipe.SyntheticDataset(10, 8), **kw)
    assert len(port) == len(ref) == (2 if drop_last else 3)
    assert_same_batches(batches(port), batches(ref))


@pytest.mark.parametrize("cls", ["DataLoader", "DeviceDataLoader"])
def test_resume_hooks_match_jax(cls):
    """``skip_epoch`` replays one permutation without decoding; ``iter_batches(start)``
    opens an epoch at a batch offset. The device loader follows the host
    loader's order."""
    kw = dict(batch_size=3, shuffle=True, seed=2)
    ref = jpipe.DataLoader(jpipe.SyntheticDataset(11, 8), prefetch_batches=0, **kw)
    if cls == "DataLoader":
        port = pipeline.DataLoader(pipeline.SyntheticDataset(11, 8), prefetch_batches=2, **kw)
    else:
        port = pipeline.DeviceDataLoader(pipeline.SyntheticDataset(11, 8), device="cpu", **kw)
    for loader in (port, ref):
        loader.skip_epoch()
    got = [np.asarray(b) for b in port.iter_batches(2)] + batches(port, 1)
    want = [np.asarray(b) for b in ref.iter_batches(2)] + batches(ref, 1)
    assert_same_batches(got, want)


@pytest.mark.parametrize("rank", [0, 1])
def test_process_sharding_matches_jax(rank):
    kw = dict(batch_size=4, seed=1, prefetch_batches=0, process_index=rank, process_count=2)
    port = pipeline.DataLoader(pipeline.SyntheticDataset(10, 8), **kw)
    ref = jpipe.DataLoader(jpipe.SyntheticDataset(10, 8), **kw)
    got = batches(port)
    assert all(b.shape[0] == 2 for b in got) and len(got) == 4   # partial tail dropped
    assert_same_batches(got, batches(ref))


def test_prefetch_thread_is_cancelled_when_the_consumer_stops():
    loader = pipeline.DataLoader(pipeline.SyntheticDataset(40, 8), batch_size=2,
                                 prefetch_batches=2)
    it = loader.iter_batches(0)
    next(it)
    it.close()                        # must not hang on the producer's full queue
    assert len(list(loader)) == 20


@pytest.mark.parametrize("drop_last", [False, True])
def test_device_loader_on_cpu_equals_host_loader(drop_last):
    kw = dict(batch_size=4, shuffle=True, drop_last=drop_last, seed=9)
    dev = pipeline.DeviceDataLoader(pipeline.SyntheticDataset(10, 8), device="cpu", **kw)
    host = pipeline.DataLoader(pipeline.SyntheticDataset(10, 8), prefetch_batches=0, **kw)
    got = [b for _ in range(2) for b in dev]
    assert all(isinstance(b, torch.Tensor) and b.dtype == torch.float32 for b in got)
    assert len(dev) == len(host)
    assert_same_batches([b.numpy() for b in got], batches(host))


# one process of a two-process gloo world: the hbm_cache loader make_loader
# builds there, over two epochs and a third resumed at batch 2
HBM_WORKER = """
import sys
import numpy as np
import torch
import torch.distributed as td
from vaegan_tpu_torch.config import DataConfig
from vaegan_tpu_torch.data import pipeline

torch.set_num_threads(1)
rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
td.init_process_group("gloo", init_method="file://" + store, world_size=2, rank=rank)
try:
    cfg = DataConfig(image_size=8, batch_size=8, synthetic=True, synthetic_size=36,
                     prefetch=0, hbm_cache=True)
    dev = pipeline.make_loader(cfg, seed=3, device="cpu", microbatches=2)
    assert isinstance(dev, pipeline.DeviceDataLoader)
    got = [b for _ in range(2) for b in dev] + list(dev.iter_batches(2))
    np.save(out, np.stack([b.numpy() for b in got]))
finally:
    td.destroy_process_group()
"""


def test_device_loader_in_two_processes_equals_the_sharded_host_loader(tmp_path):
    """Two gloo processes, each with the whole dataset staged on its device:
    every batch bitwise the rank-sharded host loader's, with ``grad_accum`` 2's
    rows of each microbatch, over two epochs and a resume through
    ``iter_batches``."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(root), os.environ.get("PYTHONPATH")) if p))
    outs = [tmp_path / f"rank{r}.npy" for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", HBM_WORKER, str(r),
                               str(tmp_path / "store"), str(outs[r])],
                              cwd=root, env=env, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), "".join(errs)[-3000:]
    for r in range(2):
        host = pipeline.DataLoader(pipeline.SyntheticDataset(36, 8), batch_size=8, seed=3,
                                   prefetch_batches=0, process_index=r, process_count=2,
                                   microbatches=2)
        want = batches(host) + list(host.iter_batches(2))
        assert len(want) == 2 * 4 + 2 and want[0].shape == (4, 8, 8, 1)
        assert_same_batches(list(np.load(outs[r])), want)


def test_device_prefetch_on_cpu_passes_batches_through():
    host = pipeline.DataLoader(pipeline.SyntheticDataset(10, 8), batch_size=4, seed=1)
    want = list(pipeline.DataLoader(pipeline.SyntheticDataset(10, 8), batch_size=4, seed=1))
    got = list(pipeline.device_prefetch(iter(host), "cpu", depth=2))
    assert all(isinstance(b, torch.Tensor) for b in got)
    assert_same_batches([b.numpy() for b in got], want)


def test_make_loader_and_defaults_to_cuda():
    cfg = DataConfig(image_size=8, batch_size=4, synthetic=True, synthetic_size=12, prefetch=0)
    host = pipeline.make_loader(cfg, seed=4)
    assert isinstance(host, pipeline.DataLoader)
    want = batches(jpipe.make_loader(jpipe.DataConfig(
        image_size=8, batch_size=4, synthetic=True, synthetic_size=12, prefetch=0), seed=4))
    assert_same_batches(batches(host), want)
    dev = pipeline.make_loader(cfg.replace(hbm_cache=True), seed=4, device="cpu")
    assert isinstance(dev, pipeline.DeviceDataLoader)
    assert_same_batches(batches(dev), want)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pipeline.make_loader(cfg.replace(hbm_cache=True), seed=4)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            next(pipeline.device_prefetch(iter(host)))


# ---------------------------------------------------------------- the cache
def test_cached_dataset_matches_jax_and_publishes_atomically(tmp_path):
    port = pipeline.CachedDataset(pipeline.SyntheticDataset(7, 8, style="edges"),
                                  cache_path=tmp_path / "p" / "cache.npy")
    ref = jpipe.CachedDataset(jpipe.SyntheticDataset(7, 8, style="edges"),
                              cache_path=tmp_path / "j" / "cache.npy")
    np.testing.assert_array_equal(port.load_batch([6, 0, 3]), ref.load_batch([6, 0, 3]))
    # published by rename: no tmp file is left, and a second run reads the file
    assert sorted(p.name for p in (tmp_path / "p").iterdir()) == ["cache.npy"]
    again = pipeline.CachedDataset(pipeline.SyntheticDataset(7, 8, style="edges"),
                                   cache_path=tmp_path / "p" / "cache.npy")
    np.testing.assert_array_equal(again.load_batch(range(7)), ref.load_batch(range(7)))
    mem = pipeline.CachedDataset(pipeline.SyntheticDataset(7, 8, style="edges"))
    np.testing.assert_array_equal(mem[4], ref[4])
    with pytest.raises(ValueError, match="shape"):
        pipeline.CachedDataset(pipeline.SyntheticDataset(7, 10),
                               cache_path=tmp_path / "p" / "cache.npy")


@pytest.fixture(scope="module")
def nii_dir(tmp_path_factory):
    """NIfTI fixtures written by the port: 30x24 float images (a resize runs at
    any output size) as .nii and .nii.gz."""
    d = tmp_path_factory.mktemp("nii")
    rng = np.random.default_rng(0)
    for i in range(5):
        img = rng.normal(size=(30, 24)).astype(np.float32) * 100 + 50
        nifti.write_nifti(d / (f"hand_{i:03d}.nii" + (".gz" if i % 2 else "")), img)
    return d


def test_cache_fingerprint_mismatch_raises_and_missing_sidecar_adopts(nii_dir, tmp_path):
    ds = pipeline.NiftiDataset(nii_dir, 16)
    path = tmp_path / "c.npy"
    pipeline.CachedDataset(ds, cache_path=path)
    meta = tmp_path / "c.npy.meta"
    assert meta.read_text() == jpipe.CachedDataset(
        jpipe.NiftiDataset(nii_dir, 16), cache_path=tmp_path / "j.npy")._fingerprint()
    meta.write_text("a different source")
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        pipeline.CachedDataset(ds, cache_path=path)
    meta.unlink()
    with pytest.warns(UserWarning, match="no fingerprint sidecar"):
        cached = pipeline.CachedDataset(ds, cache_path=path)
    assert meta.read_text() == cached._fingerprint()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pipeline.CachedDataset(ds, cache_path=path)     # adopted: no warning now


# ---------------------------------------------------------------- NIfTI
def test_writer_and_python_decoder_match_jax_bitwise(nii_dir, tmp_path):
    img = np.random.default_rng(1).normal(size=(30, 24)).astype(np.float32)
    for name in ("a.nii", "a.nii.gz"):
        nifti.write_nifti(tmp_path / f"p_{name}", img)
        jnifti.write_nifti(tmp_path / f"j_{name}", img)
        np.testing.assert_array_equal(nifti.read_nifti(tmp_path / f"p_{name}"),
                                      jnifti.read_nifti(tmp_path / f"j_{name}"))
    assert (tmp_path / "p_a.nii").read_bytes() == (tmp_path / "j_a.nii").read_bytes()
    for size in (16, 40):
        np.testing.assert_array_equal(nifti.resize_bilinear(img, size, size),
                                      jnifti.resize_bilinear(img, size, size))
    for f in sorted(nii_dir.iterdir()):
        np.testing.assert_array_equal(nifti.load_image(f, 16, use_native=False),
                                      jnifti.load_image(f, 16, use_native=False))


def test_python_decoder_rejects_a_detached_pair(tmp_path):
    p = tmp_path / "pair.nii"
    nifti.write_nifti(p, np.ones((3, 4), np.float32))
    raw = bytearray(p.read_bytes())
    raw[344:348] = b"ni1\x00"
    p.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="detached"):
        nifti.read_nifti(p)


native = pytest.mark.skipif(not nifti.have_native(),
                            reason=f"native decoder not built: {nifti.native_error()}")


@native
def test_native_decoder_matches_python_decoder(nii_dir):
    for f in sorted(nii_dir.iterdir()):
        np.testing.assert_allclose(nifti.load_image(f, 16), jnifti.load_image(f, 16, use_native=False),
                                   rtol=0, atol=1e-6)
    port = pipeline.NiftiDataset(nii_dir, 16, num_workers=2)
    ref = jpipe.NiftiDataset(nii_dir, 16)
    np.testing.assert_allclose(port.load_batch([4, 0, 2]),
                               np.stack([ref[i] for i in (4, 0, 2)]), rtol=0, atol=1e-6)


@native
def test_native_decoder_errors_are_raised(tmp_path):
    (tmp_path / "bogus.nii").write_bytes(b"\x00" * 400)
    with pytest.raises(ValueError):
        nifti.load_image(tmp_path / "bogus.nii", 16)
    with pytest.raises(ValueError, match="batch decode failed"):
        pipeline.NiftiDataset(tmp_path, 16).load_batch([0])


# ---------------------------------------------------------------- fetch
def test_fetch_extracts_like_jax(tmp_path):
    zpath = tmp_path / "ImagesHands.zip"
    with zipfile.ZipFile(zpath, "w") as zf:
        zf.writestr("nested/a.nii", b"x" * 10)
        zf.writestr("b.nii.gz", b"y" * 7)
        zf.writestr("readme.txt", b"z")
    n = fetch.fetch_dataset(url=zpath.as_uri(), dest=str(tmp_path / "p"))
    assert n == jfetch.fetch_dataset(archive_path=str(zpath), dest=str(tmp_path / "j")) == 2
    assert sorted(p.name for p in (tmp_path / "p").iterdir()) == ["a.nii", "b.nii.gz"]
    assert (tmp_path / "p" / "a.nii").read_bytes() == (tmp_path / "j" / "a.nii").read_bytes()
