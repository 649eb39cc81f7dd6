"""Read the JAX package's Orbax checkpoints with neither JAX, Orbax nor TensorStore.

``vaegan_tpu.checkpoint.CheckpointManager`` saves a ``TrainState`` as
``<directory>/<step>/``: ``default/_METADATA`` (JSON: the tree's key paths and
each leaf's value type) and the arrays as zarr v2 in an OCDBT key-value store
under ``default/`` (``manifest.ocdbt``, B-tree nodes and values in data files
under ``d/`` and ``ocdbt.process_<i>/d/``). This module reads that store:

- a manifest (magic ``0c db 3a 2a``) or B-tree node (``0c db 20 de``) file is
  the magic, its length (uint64 LE), a version varint (0), a compression varint
  (0 none, 1 zstd), the body and a CRC-32C (Castagnoli) of every byte before
  it, which is checked;
- the manifest's body: the config (uuid, manifest kind, limits, the version
  tree's arity, the compression), then the newest versions inline (a data-file
  table, each version's generation, root height, root node reference and
  statistics, commit time), then references to older version-tree nodes, not
  read here;
- a node's body: its height, a data-file table, its keys (each a prefix shared
  with the key before it and a suffix), then for a leaf each value's length,
  kind (inline or in a data file) and place, and for an interior node each
  child's shared key-prefix length, reference and statistics;
- a zarr v2 array is ``<path>/.zarray`` (JSON) and its chunks ``<path>/<i>.<j>...``,
  each zstd-compressed; its values are not checked.

zstd frames are decompressed by the system's zstd library (``libzstd.so.1``)
through ``ctypes``; without it, reading raises and names the library.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import json
import os
import struct
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
_NO_ROOT = 2 ** 64 - 1          # the root reference of a version with no keys
KEY_SEQUENCE = 1                # _METADATA's key type of a list index (2: a mapping key)

Array = Union[np.ndarray, torch.Tensor]


# ---------------------------------------------------------------- zstd
class _ZstdBuffer(ctypes.Structure):
    _fields_ = [("data", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


_CONTENT_UNKNOWN = 2 ** 64 - 1
_CONTENT_ERROR = 2 ** 64 - 2
_LIB: Optional[ctypes.CDLL] = None


def zstd_library() -> ctypes.CDLL:
    """The system's zstd library, loaded once."""
    global _LIB
    if _LIB is None:
        name = ctypes.util.find_library("zstd") or "libzstd.so.1"
        try:
            lib = ctypes.CDLL(name)
        except OSError as e:
            raise RuntimeError(f"reading an Orbax checkpoint needs zstd's C library "
                               f"(libzstd.so.1), which could not be loaded: {e}") from e
        size_t, vp = ctypes.c_size_t, ctypes.c_void_p
        for fn, res, args in (
                ("ZSTD_decompress", size_t, (vp, size_t, vp, size_t)),
                ("ZSTD_getFrameContentSize", ctypes.c_ulonglong, (vp, size_t)),
                ("ZSTD_isError", ctypes.c_uint, (size_t,)),
                ("ZSTD_getErrorName", ctypes.c_char_p, (size_t,)),
                ("ZSTD_createDStream", vp, ()),
                ("ZSTD_freeDStream", size_t, (vp,)),
                ("ZSTD_initDStream", size_t, (vp,)),
                ("ZSTD_decompressStream", size_t,
                 (vp, ctypes.POINTER(_ZstdBuffer), ctypes.POINTER(_ZstdBuffer)))):
            getattr(lib, fn).restype, getattr(lib, fn).argtypes = res, args
        _LIB = lib
    return _LIB


def _check(lib, code: int) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd: {lib.ZSTD_getErrorName(code).decode()}")
    return code


def zstd_decompress(data: bytes, into: Optional[np.ndarray] = None):
    """The decompressed bytes of one or more zstd frames. With ``into`` (a
    C-contiguous array) they are written there, and must fill it exactly: a
    large array is then decompressed in place, not copied. One
    ``ZSTD_decompress`` call where the first frame states its size (and, with
    ``into``, that is the array's), else ``ZSTD_decompressStream``."""
    lib = zstd_library()
    src = ctypes.c_char_p(data)
    size = lib.ZSTD_getFrameContentSize(src, len(data))
    if size == _CONTENT_ERROR:
        raise ValueError("zstd: not a zstd frame")
    if size != _CONTENT_UNKNOWN and (into is None or size == into.nbytes):
        buf = ctypes.create_string_buffer(max(size, 1)) if into is None else None
        dst = ctypes.addressof(buf) if into is None else into.ctypes.data
        got = lib.ZSTD_decompress(dst, size, src, len(data))
        if not lib.ZSTD_isError(got) and got == size:
            return buf.raw[:size] if into is None else into
    return _zstd_stream(lib, src, len(data), into)


def _zstd_stream(lib, src, n: int, into: Optional[np.ndarray]):
    stream = lib.ZSTD_createDStream()
    if not stream:
        raise MemoryError("zstd: ZSTD_createDStream failed")
    try:
        _check(lib, lib.ZSTD_initDStream(stream))
        inp = _ZstdBuffer(ctypes.cast(src, ctypes.c_void_p), n, 0)
        if into is None:            # unknown size: chunks of up to 64 MiB, joined
            size = max(1 << 16, min(4 * n, 1 << 26))
            buf = ctypes.create_string_buffer(size)
            out = _ZstdBuffer(ctypes.addressof(buf), size, 0)
        else:
            out = _ZstdBuffer(into.ctypes.data, into.nbytes, 0)
        parts = []
        while True:
            if into is None:
                out.pos = 0
            before = inp.pos, out.pos
            left = _check(lib, lib.ZSTD_decompressStream(stream, ctypes.byref(out),
                                                         ctypes.byref(inp)))
            if into is None:
                parts.append(ctypes.string_at(buf, out.pos))
            if inp.pos == inp.size and left == 0:      # every frame decoded and flushed
                break
            if (inp.pos, out.pos) == before:           # no input used, no output made
                raise ValueError("zstd: the frames hold more than the array"
                                 if out.pos == out.size else "zstd: the data ends inside a frame")
        if into is None:
            return b"".join(parts)
        if out.pos != out.size:
            raise ValueError(f"zstd: the frames hold {out.pos} bytes, the array {out.size}")
        return into
    finally:
        lib.ZSTD_freeDStream(stream)


# ---------------------------------------------------------------- OCDBT
def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    table = _CRC32C
    for byte in data:
        c = table[(c ^ byte) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Cursor:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def varint(self) -> int:
        value = shift = 0
        while True:
            byte = self.data[self.pos]
            self.pos += 1
            value |= (byte & 0x7F) << shift
            shift += 7
            if not byte & 0x80:
                return value

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("OCDBT: a node ends early")
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]


def _unwrap(blob: bytes, magic: int, what: str) -> _Cursor:
    """The body of a manifest or node file, its checksum checked."""
    if len(blob) < 18 or struct.unpack(">I", blob[:4])[0] != magic:
        raise ValueError(f"OCDBT: {what} does not start with the magic {magic:08x}")
    (length,) = struct.unpack("<Q", blob[4:12])
    if length != len(blob):
        raise ValueError(f"OCDBT: {what} states {length} bytes, holds {len(blob)}")
    (crc,) = struct.unpack("<I", blob[-4:])
    if crc32c(blob[:-4]) != crc:
        raise ValueError(f"OCDBT: {what} fails its CRC-32C check")
    head = _Cursor(blob[:-4])
    head.pos = 12
    if head.varint() != 0:
        raise ValueError(f"OCDBT: {what} has an unknown format version")
    compression = head.varint()
    body = blob[head.pos:-4]
    if compression == 1:
        body = zstd_decompress(body)
    elif compression != 0:
        raise ValueError(f"OCDBT: {what} has unknown compression {compression}")
    return _Cursor(body)


def _data_files(c: _Cursor) -> List[str]:
    """A data-file table: each file's path (base path + relative path), each
    path stored as a prefix shared with the path before it and a suffix."""
    n = c.varint()
    shared = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    c.varints(n)                    # where the base path ends: not needed to find the file
    paths, prev = [], b""
    for i in range(n):
        prev = prev[:shared[i]] + c.take(suffix[i])
        paths.append(prev.decode())
    return paths


def _keys(c: _Cursor, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    shared = [0] + c.varints(n - 1) if n else []
    suffix = c.varints(n)
    subtree = c.varints(n) if interior else []
    keys, prev = [], b""
    for i in range(n):
        prev = prev[:shared[i]] + c.take(suffix[i])
        keys.append(prev)
    return keys, subtree


Ref = Tuple[str, int, int]        # (data file path, offset, length)


class OcdbtStore:
    """The keys and values of an OCDBT key-value store's newest version
    (``directory`` holds its ``manifest.ocdbt``). Inline values are held in
    memory; the rest are read from their data files when asked for."""

    def __init__(self, directory: str):
        self.directory = directory
        path = os.path.join(directory, "manifest.ocdbt")
        with open(path, "rb") as f:
            c = _unwrap(f.read(), MANIFEST_MAGIC, path)
        c.take(16)                                  # uuid
        if c.varint() != 0:
            raise ValueError(f"OCDBT: {path} is a numbered manifest, which is not read here")
        c.varint(), c.varint(), c.byte()            # inline limit, node limit, arity
        if c.varint() == 1:
            c.take(4)                               # zstd level
        files = _data_files(c)
        n = c.varint()
        generation = c.varints(n)
        height = list(c.take(n))
        where = list(zip(c.varints(n), c.varints(n), c.varints(n)))
        if not n:
            raise ValueError(f"OCDBT: {path} holds no version")
        newest = max(range(n), key=generation.__getitem__)
        self._values: Dict[str, Union[bytes, Ref]] = {}
        self.height = height[newest]                # of the B-tree's root: 0 is a leaf
        file, offset, length = where[newest]
        if offset != _NO_ROOT:
            self._node((files[file], offset, length), height[newest], b"")

    def _read(self, ref: Ref) -> bytes:
        path, offset, length = ref
        with open(os.path.join(self.directory, path), "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"OCDBT: {path} ends before byte {offset + length}")
        return data

    def _node(self, ref: Ref, height: int, prefix: bytes) -> None:
        c = _unwrap(self._read(ref), NODE_MAGIC, f"the node at {ref}")
        if c.byte() != height:
            raise ValueError(f"OCDBT: the node at {ref} is not of height {height}")
        files = _data_files(c)
        n = c.varint()
        keys, subtree = _keys(c, n, interior=height > 0)
        if height:
            where = list(zip(c.varints(n), c.varints(n), c.varints(n)))
            for key, common, (file, offset, length) in zip(keys, subtree, where):
                self._node((files[file], offset, length), height - 1, prefix + key[:common])
            return
        lengths = c.varints(n)
        indirect = list(c.take(n))
        m = sum(indirect)
        refs = iter(zip(c.varints(m), c.varints(m)))
        for key, length, kind in zip(keys, lengths, indirect):
            if kind:
                file, offset = next(refs)
                value: Union[bytes, Ref] = (files[file], offset, length)
            else:
                value = c.take(length)
            self._values[(prefix + key).decode()] = value

    def keys(self) -> List[str]:
        return sorted(self._values)

    def __contains__(self, key: str) -> bool:
        return key in self._values

    def __getitem__(self, key: str) -> bytes:
        value = self._values[key]
        return value if isinstance(value, bytes) else self._read(value)


# ---------------------------------------------------------------- zarr v2
def read_array(store: OcdbtStore, path: str) -> Array:
    """The zarr v2 array at ``path``: a numpy array, or a torch tensor for
    bfloat16, which numpy has no type for."""
    meta = json.loads(store[f"{path}/.zarray"])
    if meta.get("zarr_format") != 2 or meta.get("order", "C") != "C" or meta.get("filters"):
        raise ValueError(f"{path}: only C-order zarr v2 arrays without filters are read")
    compressor = (meta.get("compressor") or {}).get("id")
    if compressor not in (None, "zstd"):
        raise ValueError(f"{path}: compressor {compressor!r} is not read here")
    bf16 = meta["dtype"] == "bfloat16"
    dtype = np.dtype("<u2" if bf16 else meta["dtype"])
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    out = np.zeros(shape, dtype)            # where a chunk is missing: the fill value
    if meta.get("fill_value") not in (None, 0):
        out[...] = meta["fill_value"]
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for index in np.ndindex(*grid):
        key = f"{path}/{sep.join(map(str, index)) if index else '0'}"
        if key not in store:
            continue
        raw = store[key]
        whole = chunks == shape             # one chunk: decompressed into the array itself
        chunk = out if whole else np.empty(chunks, dtype)
        if compressor:
            zstd_decompress(raw, chunk)
        else:
            chunk.reshape(-1).view(np.uint8)[:] = np.frombuffer(raw, np.uint8)
        if not whole:
            where = tuple(slice(i * c, min((i + 1) * c, s))
                          for i, c, s in zip(index, chunks, shape))
            out[where] = chunk[tuple(slice(0, w.stop - w.start) for w in where)]
    if bf16:
        return torch.frombuffer(bytearray(out.tobytes()), dtype=torch.bfloat16).reshape(shape)
    return out


# ---------------------------------------------------------------- the tree
def tree_metadata(step_dir: str) -> Dict[str, Any]:
    """``_METADATA``'s ``tree_metadata`` of a step directory."""
    with open(os.path.join(step_dir, "default", "_METADATA")) as f:
        return json.load(f)["tree_metadata"]


def _listed(node: Any, path: Tuple[str, ...], sequences: set) -> Any:
    """``node`` with each mapping whose keys were list indices made a list."""
    if not isinstance(node, dict):
        return node
    items = {k: _listed(v, path + (k,), sequences) for k, v in node.items()}
    if path in sequences:
        return [items[k] for k in sorted(items, key=int)]
    return items


def read_tree(step_dir: str) -> Dict[str, Any]:
    """The saved tree of ``<directory>/<step>``: nested dicts (a namedtuple's
    fields are mapping keys on disk, as Orbax writes them), lists for
    sequences, arrays at the leaves and None where the saved value was None
    (an absent EMA, an empty optimizer state)."""
    store = OcdbtStore(os.path.join(step_dir, "default"))
    root: Dict[str, Any] = {}
    sequences = set()
    for entry in tree_metadata(step_dir).values():
        keys = entry["key_metadata"]
        names = [k["key"] for k in keys]
        sequences.update(tuple(names[:i]) for i, k in enumerate(keys)
                         if k["key_type"] == KEY_SEQUENCE)
        vtype = entry["value_metadata"]["value_type"]
        if vtype == "None":
            value = None
        elif vtype in ("jax.Array", "np.ndarray"):
            value = read_array(store, ".".join(names))
        else:
            raise ValueError(f"{'.'.join(names)}: Orbax value type {vtype!r} is not read here")
        node = root
        for name in names[:-1]:
            node = node.setdefault(name, {})
        node[names[-1]] = value
    return _listed(root, (), sequences)
