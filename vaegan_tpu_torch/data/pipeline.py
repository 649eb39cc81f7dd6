"""Host data pipeline feeding device batches (port of ``vaegan_tpu/data/pipeline.py``).

Decode runs in a host thread (the C++ batch decoder releases the GIL), batches
are assembled as NHWC float32 numpy arrays, and :func:`device_prefetch` keeps
``depth`` batches in flight to the card: pinned host buffers copied with
``non_blocking`` on a side CUDA stream, so the copy overlaps the previous step.
:class:`DeviceDataLoader` instead keeps the whole decoded dataset in device
memory and gathers each batch there.

The datasets and the host loader are the JAX package's, line for line: the same
seed gives the same images and the same batch order, so a run fed by either
package sees the same data. Batches stay NHWC float32, the layout the port's
generator and train step take.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import queue
import threading
import warnings
from collections import deque
from pathlib import Path
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from vaegan_tpu_torch.config import DataConfig
from vaegan_tpu_torch.data import nifti
from vaegan_tpu_torch.ops.replica import rank_rows
from vaegan_tpu_torch.utils.profiling import span


def resolve_device(device) -> torch.device:
    # imported here: the train package imports this module for its loop
    from vaegan_tpu_torch.train.state import resolve_device as resolve

    return resolve(device)


class NiftiDataset:
    """Directory of .nii / .nii.gz files -> normalized, resized (H, W, 1) images
    (the reference's NiftyDataset plus the resize it documents)."""

    def __init__(self, root_dir, image_size: int = 96, normalize: bool = True,
                 num_workers: int = 0):
        self.root_dir = Path(root_dir)
        self.image_size = image_size
        self.normalize = normalize
        self.num_workers = num_workers  # C++ decode threads; 0 = hw concurrency
        self.filenames = sorted(
            f for f in os.listdir(self.root_dir)
            if str(f).endswith((".nii", ".nii.gz")))
        if not self.filenames:
            raise FileNotFoundError(f"no NIfTI files under {self.root_dir}")

    def __len__(self) -> int:
        return len(self.filenames)

    def __getitem__(self, idx: int) -> np.ndarray:
        return nifti.load_image(self.root_dir / self.filenames[idx],
                                self.image_size, self.normalize)

    def load_batch(self, indices: Sequence[int]) -> np.ndarray:
        """Decode a batch; the C++ multi-threaded batch decoder when it builds."""
        lib = nifti._load_lib()
        if lib is None:
            return np.stack([self[i] for i in indices])
        n = len(indices)
        out = np.empty((n, self.image_size, self.image_size), np.float32)
        paths = (ctypes.c_char_p * n)(
            *[str(self.root_dir / self.filenames[i]).encode() for i in indices])
        rc = lib.nifti_decode_batch(
            paths, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.image_size, self.image_size, int(self.normalize), int(self.num_workers))
        if rc != 0:
            raise ValueError(f"batch decode failed: {lib.nifti_last_error().decode()}")
        return out[..., None]


class SyntheticDataset:
    """Deterministic synthetic images in [0, 1] shaped like the hand X-rays.

    - ``"blobs"`` (default): smooth low-frequency random fields;
    - ``"edges"``: the same fields quantized into discrete levels (sharp
      iso-contours at positions the smooth field decides);
    - ``"texture"``: the quantized low-frequency field plus a quantized field
      whose base resolution is ``image_size // 4``, so the share of edge pixels
      holds at any output size.

    The same ``(size, image_size, seed, style)`` gives the JAX package's arrays
    bit for bit (numpy draws, numpy resize).
    """

    def __init__(self, size: int = 1200, image_size: int = 96, seed: int = 0,
                 style: str = "blobs"):
        if style not in ("blobs", "edges", "texture"):
            raise ValueError(
                f"synthetic style must be 'blobs'|'edges'|'texture', got {style!r}")
        self.size = size
        self.image_size = image_size
        self.style = style
        self._rng = np.random.default_rng(seed)
        self._low = self._rng.normal(size=(size, 12, 12)).astype(np.float32)
        if style == "texture":
            fine = max(image_size // 4, 3)
            self._fine = self._rng.normal(size=(size, fine, fine)).astype(np.float32)

    def __len__(self) -> int:
        return self.size

    @staticmethod
    def _quantize(img: np.ndarray, levels: int = 6) -> np.ndarray:
        lo, hi = img.min(), img.max()
        img = (img - lo) / max(hi - lo, 1e-12)
        return np.floor(img * levels).clip(max=levels - 1) / (levels - 1)

    def __getitem__(self, idx: int) -> np.ndarray:
        img = nifti.resize_bilinear(self._low[idx], self.image_size, self.image_size)
        if self.style == "edges":
            img = self._quantize(img)
        elif self.style == "texture":
            fine = nifti.resize_bilinear(self._fine[idx],
                                         self.image_size, self.image_size)
            img = 0.6 * self._quantize(img) + 0.4 * self._quantize(fine)
        else:
            lo, hi = img.min(), img.max()
            img = (img - lo) / max(hi - lo, 1e-12)
        return img.astype(np.float32)[..., None]

    def load_batch(self, indices: Sequence[int]) -> np.ndarray:
        return np.stack([self[i] for i in indices])


class CachedDataset:
    """Decode-once, memory-mapped dataset cache.

    The whole dataset is decoded once into a float32 (N, image_size, image_size,
    1) array; later epochs read it from the page cache. With ``cache_path`` the
    cache is a ``.npy`` file reused across runs: it is written under a
    temporary name and renamed into place, so a killed run never leaves a
    valid-looking half-filled cache, and a sidecar ``<cache>.meta`` holds a
    fingerprint of the source files (name, size, mtime) that a later run checks.
    """

    def __init__(self, dataset, cache_path=None):
        self.dataset = dataset
        self.image_size = dataset.image_size
        n = len(dataset)
        shape = (n, dataset.image_size, dataset.image_size, 1)
        if cache_path is None:
            self._mm = np.zeros(shape, np.float32)
            self._populate(dataset, n)
        else:
            cache_path = Path(cache_path)
            cache_path.parent.mkdir(parents=True, exist_ok=True)
            if cache_path.exists():
                self._check_meta(cache_path)
                self._mm = np.load(str(cache_path), mmap_mode="r")
                if self._mm.shape != shape:
                    raise ValueError(
                        f"cache {cache_path} has shape {self._mm.shape}, expected "
                        f"{shape} — delete it or point cache_path elsewhere")
            else:
                # the pid keeps concurrent populators on a shared file system
                # from writing one tmp file; every writer writes the same content
                tmp = cache_path.with_suffix(f".tmp{os.getpid()}.npy")
                self._mm = np.lib.format.open_memmap(
                    str(tmp), mode="w+", dtype=np.float32, shape=shape)
                self._populate(dataset, n)
                self._mm.flush()
                del self._mm
                # the sidecar before the rename: a crash in between leaves a
                # sidecar without a cache (rebuilt next run), never a published
                # cache whose provenance cannot be checked
                self._write_meta(cache_path)
                os.replace(tmp, cache_path)
                self._mm = np.load(str(cache_path), mmap_mode="r")

    def _populate(self, dataset, n, bs: int = 64):
        for s in range(0, n, bs):
            idx = range(s, min(s + bs, n))
            self._mm[s: s + len(idx)] = dataset.load_batch(idx)

    def _fingerprint(self):
        """Hash of (filename, size, mtime): the shape alone cannot tell a
        swapped dataset of the same length."""
        ds = self.dataset
        if not hasattr(ds, "filenames") or not hasattr(ds, "root_dir"):
            return None
        h = hashlib.sha1()
        for f in ds.filenames:
            st_ = os.stat(Path(ds.root_dir) / f)
            h.update(f"{f}:{st_.st_size}:{st_.st_mtime_ns}".encode())
        return h.hexdigest()

    def _meta_path(self, cache_path):
        return Path(str(cache_path) + ".meta")

    def _write_meta(self, cache_path):
        fp = self._fingerprint()
        if fp is not None:
            self._meta_path(cache_path).write_text(fp)

    def _check_meta(self, cache_path):
        fp = self._fingerprint()
        if fp is None:  # the dataset carries no provenance (e.g. synthetic)
            return
        meta = self._meta_path(cache_path)
        if not meta.exists():
            # a cache from before the sidecar existed: adopt it and record
            # today's fingerprint, so any later change of the source is caught
            warnings.warn(
                f"cache {cache_path} has no fingerprint sidecar ({meta.name}); "
                "adopting it and writing the current source fingerprint — "
                "delete the cache file to force a rebuild instead",
                stacklevel=3)
            meta.write_text(fp)
            return
        if meta.read_text() != fp:
            raise ValueError(
                f"cache {cache_path} was built from different source files "
                "(fingerprint mismatch) — delete it to rebuild")

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, idx: int) -> np.ndarray:
        return np.asarray(self._mm[idx])

    def load_batch(self, indices: Sequence[int]) -> np.ndarray:
        return np.asarray(self._mm[np.asarray(indices)])


def _batch_starts(n: int, batch_size: int, drop_last: bool) -> range:
    return range(0, n - batch_size + 1, batch_size) if drop_last else range(0, n, batch_size)


class DataLoader:
    """Shuffled, batched host iterator with a decode-ahead thread.

    Mirrors torch ``DataLoader(dataset, shuffle=True, batch_size=4,
    drop_last=False)`` as the reference uses it.
    """

    def __init__(self, dataset, batch_size: int = 4, shuffle: bool = True,
                 drop_last: bool = False, seed: int = 0, prefetch_batches: int = 2,
                 process_index: int = 0, process_count: int = 1, microbatches: int = 1):
        """``batch_size`` is the GLOBAL batch size. In a multi-process run every
        process computes the same shuffle (the same ``seed``) and yields only its
        own contiguous ``batch_size / process_count`` shard of each batch (with
        ``microbatches`` k > 1, its shard of each of the k microbatches of an
        accumulating step: ``ops.replica.rank_rows``); the last partial batch is
        dropped, since it cannot be split evenly."""
        if process_count > 1 and batch_size % (process_count * microbatches) != 0:
            raise ValueError(
                f"global batch_size {batch_size} is not divisible by "
                f"process_count {process_count} x microbatches {microbatches}")
        if not (0 <= process_index < process_count):
            raise ValueError(f"process_index {process_index} out of range for "
                             f"process_count {process_count}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last or process_count > 1
        self.prefetch_batches = prefetch_batches
        self.process_index = process_index
        self.process_count = process_count
        self.microbatches = microbatches
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        return idx

    def __iter__(self) -> Iterator[np.ndarray]:
        return self.iter_batches(0)

    def skip_epoch(self) -> None:
        """Advance the shuffle stream one epoch without decoding anything (resume:
        replaying a completed epoch's permutation keeps the later epochs' order
        that of an uninterrupted run)."""
        self._epoch_indices()

    def iter_batches(self, start: int = 0) -> Iterator[np.ndarray]:
        """This epoch's batches from batch index ``start``; the earlier ones are
        skipped WITHOUT decoding (resume)."""
        idx = self._epoch_indices()
        slices = [idx[s: s + self.batch_size]
                  for s in _batch_starts(len(idx), self.batch_size, self.drop_last)][start:]
        if self.process_count > 1:
            rows = rank_rows(self.batch_size, self.process_index, self.process_count,
                             self.microbatches).numpy()
            slices = [sl[rows] for sl in slices]
        if self.prefetch_batches <= 0:
            for sl in slices:
                yield self.dataset.load_batch(sl)
            return

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_batches)
        sentinel = object()
        err: List[BaseException] = []
        stop = threading.Event()

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for sl in slices:
                    if stop.is_set() or not _put(self.dataset.load_batch(sl)):
                        return
            except BaseException as e:  # surfaced on the consumer side
                err.append(e)
            finally:
                _put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            # a consumer that stops early cancels the producer instead of
            # leaving it blocked on a full queue
            stop.set()
            while not q.empty():
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5.0)
        if err:
            raise err[0]


def _multi_process() -> bool:
    return (torch.distributed.is_available() and torch.distributed.is_initialized()
            and torch.distributed.get_world_size() > 1)


class DeviceDataLoader:
    """The whole decoded dataset resident in device memory; each batch is
    gathered there (``index_select``) with no image crossing the host link.

    At construction the dataset is decoded once and copied to ``device``. Each
    epoch copies its permutation (``len(dataset)`` int64s) to the device once,
    from pinned memory without blocking; a batch is then an ``index_select``
    with a slice of it, launched without a host sync. The epoch order, ``drop_last``
    and the resume hooks are the host :class:`DataLoader`'s for the same seed, so
    a run is bitwise the same whichever loader feeds it.

    In a multi-process run (``process_count`` > 1) every process stages the
    whole dataset on its own card (the JAX package's replicated staging, one
    copy a process), computes the same epoch permutation and gathers only its
    rows of each global batch (``ops.replica.rank_rows``; with ``microbatches``
    k > 1 its rows of each microbatch): the rows the rank-sharded host
    :class:`DataLoader` gives it. A partial last batch is dropped, as there.
    """

    def __init__(self, dataset, batch_size: int = 4, shuffle: bool = True,
                 drop_last: bool = False, seed: int = 0, device="cuda",
                 process_index: int = 0, process_count: int = 1, microbatches: int = 1):
        if not (0 <= process_index < process_count):
            raise ValueError(f"process_index {process_index} out of range for "
                             f"process_count {process_count}")
        self.device = resolve_device(device)
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last or process_count > 1
        self._rng = np.random.default_rng(seed)
        # rank_rows refuses a batch the processes and microbatches do not divide
        self._rows = (rank_rows(batch_size, process_index, process_count, microbatches)
                      .to(self.device) if process_count > 1 else None)

        host = dataset.load_batch(range(len(dataset)))
        if host.nbytes > 2 << 30:
            warnings.warn(
                f"hbm_cache is staging {host.nbytes / 2**30:.1f} GiB of images "
                "in device memory — make sure this fits next to the training "
                "working set", stacklevel=2)
        self.images = torch.from_numpy(np.ascontiguousarray(host, np.float32)).to(self.device)

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_indices(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._rng.shuffle(idx)
        return idx

    def skip_epoch(self) -> None:
        """Advance the shuffle stream one epoch without gathering (resume, as
        :meth:`DataLoader.skip_epoch`)."""
        self._epoch_indices()

    def __iter__(self) -> Iterator[torch.Tensor]:
        return self.iter_batches(0)

    def iter_batches(self, start: int = 0) -> Iterator[torch.Tensor]:
        with span("feed.epoch"):
            idx = torch.from_numpy(self._epoch_indices())
            if self.device.type == "cuda":
                idx = idx.pin_memory().to(self.device, non_blocking=True)
        for s in list(_batch_starts(len(idx), self.batch_size, self.drop_last))[start:]:
            with span("feed.gather"):
                rows = idx[s: s + self.batch_size]
                if self._rows is not None:
                    rows = rows[self._rows]
                batch = self.images.index_select(0, rows)
            yield batch


def device_prefetch(iterator: Iterator, device="cuda", depth: int = 2) -> Iterator[torch.Tensor]:
    """Stage host batches on ``device`` ``depth`` batches ahead of the consumer.

    On a CUDA device each numpy batch is written into a pinned host buffer and
    copied with ``non_blocking`` on a side stream, so the copy overlaps the
    step the card is running. Three rules keep that safe: the consumer's
    stream waits for the batch's copy (an event recorded after it on the copy
    stream) before the batch is yielded; the batch's memory is marked as used by
    the consumer's stream (``record_stream``), so the allocator does not hand it
    out again while a step still reads it; and a pinned buffer is rewritten
    only after the copy that last read it has completed. On a CPU device the
    batches pass through as tensors. A batch that is already a tensor on the
    device (:class:`DeviceDataLoader`) passes through.
    """
    dev = resolve_device(device)
    if dev.type != "cuda":
        for b in iterator:
            yield b if isinstance(b, torch.Tensor) else torch.from_numpy(np.asarray(b, np.float32))
        return
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    copy_stream = torch.cuda.Stream(dev)
    consumer = torch.cuda.current_stream(dev)
    slots: List[Optional[tuple]] = [None] * (depth + 1)     # (pinned buffer, copy event)
    ahead: "deque[tuple]" = deque()                        # (device batch, copy event)
    for n, b in enumerate(iterator):
        if isinstance(b, torch.Tensor) and b.device == dev:
            ahead.append((b, None))
        else:
            b = np.asarray(b, np.float32)
            k = n % len(slots)
            if slots[k] is None or tuple(slots[k][0].shape) != b.shape:
                slots[k] = (torch.empty(b.shape, dtype=torch.float32, pin_memory=True),
                            torch.cuda.Event())
            buf, done = slots[k]
            done.synchronize()              # the copy that last read this buffer
            buf.numpy()[...] = b
            with torch.cuda.stream(copy_stream):
                dev_batch = buf.to(dev, non_blocking=True)
                done.record(copy_stream)
            ahead.append((dev_batch, done))
        if len(ahead) > depth:
            yield _hand_over(ahead.popleft(), consumer)
    while ahead:
        yield _hand_over(ahead.popleft(), consumer)


def _hand_over(item, consumer) -> torch.Tensor:
    batch, copied = item
    if copied is not None:
        consumer.wait_event(copied)
        batch.record_stream(consumer)
    return batch


def make_dataset(cfg: DataConfig):
    if cfg.synthetic:
        ds = SyntheticDataset(cfg.synthetic_size, cfg.image_size,
                              style=cfg.synthetic_style)
    else:
        ds = NiftiDataset(cfg.root_dir, cfg.image_size, num_workers=cfg.num_workers)
    if cfg.cache:
        path = cfg.cache_path or (None if cfg.synthetic else
                                  str(Path(cfg.root_dir) / f".cache_{cfg.image_size}.npy"))
        ds = CachedDataset(ds, cache_path=path)
    return ds


def make_loader(cfg: DataConfig, seed: int = 0, process_index: Optional[int] = None,
                process_count: Optional[int] = None, drop_last: Optional[bool] = None,
                device="cuda", microbatches: int = 1):
    """The configured loader. In a multi-process ``torch.distributed`` run it
    is sharded by rank and world size (explicit values override;
    ``microbatches``: the rows of an accumulating step's microbatches, see
    :class:`DataLoader`). ``cfg.hbm_cache`` selects the :class:`DeviceDataLoader`
    on ``device``, which gathers the same rows on the card; ``drop_last``
    overrides ``cfg.drop_last`` when given."""
    if process_count is None:
        process_count = torch.distributed.get_world_size() if _multi_process() else 1
    if process_index is None:
        process_index = torch.distributed.get_rank() if process_count > 1 else 0
    if drop_last is None:
        drop_last = cfg.drop_last
    if cfg.hbm_cache:
        return DeviceDataLoader(make_dataset(cfg), batch_size=cfg.batch_size,
                                shuffle=cfg.shuffle, drop_last=drop_last, seed=seed,
                                device=device, process_index=process_index,
                                process_count=process_count, microbatches=microbatches)
    return DataLoader(make_dataset(cfg), batch_size=cfg.batch_size,
                      shuffle=cfg.shuffle, drop_last=drop_last, seed=seed,
                      prefetch_batches=cfg.prefetch,
                      process_index=process_index, process_count=process_count,
                      microbatches=microbatches)
