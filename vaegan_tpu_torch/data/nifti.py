"""NIfTI-1 decode on the host (port of ``vaegan_tpu/data/nifti.py``; no nibabel).

- ``read_nifti``: a pure-numpy NIfTI-1 parser (header + data, gzip-transparent,
  endian-aware, scl_slope/scl_inter scaling), always available;
- the native fast path: the C ABI of ``csrc/nifti_reader.cc`` (decode + min-max
  normalize + bilinear resize in one pass, a thread pool for batches, the GIL
  released), compiled at first use with the host compiler into
  ``vaegan_tpu_torch/_build/`` (``ops._build.build_host``); where no library can
  be built the Python decoder serves and :func:`native_error` says why;
- ``write_nifti`` for fixtures;
- ``resize_bilinear`` with the half-pixel-center convention
  (``torch.nn.functional.interpolate(..., mode="bilinear", align_corners=False)``).

Host code only: the decoded images are numpy arrays that the loaders hand to the
device.
"""

from __future__ import annotations

import ctypes
import gzip
import struct
from pathlib import Path
from typing import Optional, Union

import numpy as np

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32,
    64: np.float64, 256: np.int8, 512: np.uint16, 768: np.uint32,
}

_HDR_SIZE = 348


def _read_bytes(path: Union[str, Path]) -> bytes:
    p = str(path)
    if p.endswith(".gz"):
        with gzip.open(p, "rb") as f:
            return f.read()
    with open(p, "rb") as f:
        return f.read()


def read_nifti(path: Union[str, Path]) -> np.ndarray:
    """Parse a NIfTI-1 file to a float32 array in its stored (Fortran-order) shape,
    with scl_slope/scl_inter applied (matching nibabel ``get_fdata`` semantics)."""
    raw = _read_bytes(path)
    if len(raw) < _HDR_SIZE:
        raise ValueError(f"{path}: truncated NIfTI header ({len(raw)} bytes)")
    (sizeof_hdr,) = struct.unpack_from("<i", raw, 0)
    bo = "<"
    if sizeof_hdr != _HDR_SIZE:
        (sizeof_hdr,) = struct.unpack_from(">i", raw, 0)
        if sizeof_hdr != _HDR_SIZE:
            raise ValueError(f"{path}: not a NIfTI-1 file")
        bo = ">"
    dim = struct.unpack_from(f"{bo}8h", raw, 40)
    ndim = dim[0]
    if not 1 <= ndim <= 7:
        raise ValueError(f"{path}: bad ndim {ndim}")
    shape = tuple(max(1, d) for d in dim[1:1 + ndim])
    (datatype,) = struct.unpack_from(f"{bo}h", raw, 70)
    (vox_offset,) = struct.unpack_from(f"{bo}f", raw, 108)
    (scl_slope,) = struct.unpack_from(f"{bo}f", raw, 112)
    (scl_inter,) = struct.unpack_from(f"{bo}f", raw, 116)
    magic = raw[344:348]
    if magic[:3] == b"ni1":
        # a detached .hdr/.img pair keeps its voxels in a file this reader does
        # not open: decoding the header file's trailing bytes would be garbage
        raise ValueError(f"{path}: detached NIfTI-1 pair ('ni1' magic) is "
                         "unsupported; convert to single-file .nii ('n+1')")
    if magic[:3] != b"n+1":
        raise ValueError(f"{path}: bad magic {magic!r}")
    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported datatype code {datatype}")
    np_dtype = np.dtype(_DTYPES[datatype]).newbyteorder(bo)
    offset = int(vox_offset) if vox_offset >= _HDR_SIZE else _HDR_SIZE
    count = int(np.prod(shape))
    data = np.frombuffer(raw, dtype=np_dtype, count=count, offset=offset)
    img = data.reshape(shape, order="F").astype(np.float32)
    if scl_slope not in (0.0, 1.0) and np.isfinite(scl_slope):
        img = img * scl_slope + (scl_inter if np.isfinite(scl_inter) else 0.0)
    elif scl_inter not in (0.0,) and scl_slope == 1.0 and np.isfinite(scl_inter):
        img = img + scl_inter
    return img


def write_nifti(path: Union[str, Path], img: np.ndarray) -> None:
    """Minimal NIfTI-1 writer (float32, single-file .nii[.gz]) for fixtures."""
    img = np.asarray(img, np.float32)
    hdr = bytearray(_HDR_SIZE)
    struct.pack_into("<i", hdr, 0, _HDR_SIZE)
    dims = [img.ndim] + list(img.shape) + [1] * (7 - img.ndim)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, 16)           # float32
    struct.pack_into("<h", hdr, 72, 32)           # bitpix
    struct.pack_into("<8f", hdr, 76, 1, 1, 1, 1, 1, 1, 1, 1)  # pixdim
    struct.pack_into("<f", hdr, 108, 352.0)       # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)         # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)         # scl_inter
    hdr[344:348] = b"n+1\x00"
    payload = bytes(hdr) + b"\x00" * 4 + img.tobytes(order="F")
    p = str(path)
    if p.endswith(".gz"):
        with gzip.open(p, "wb") as f:
            f.write(payload)
    else:
        with open(p, "wb") as f:
            f.write(payload)


def resize_bilinear(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize of a 2-D array, half-pixel-center convention
    (align_corners=False, as torch interpolate, PIL and the C++ path)."""
    h, w = img.shape
    if (h, w) == (out_h, out_w):
        return np.asarray(img, np.float32)
    ys = (np.arange(out_h, dtype=np.float32) + 0.5) * (h / out_h) - 0.5
    xs = (np.arange(out_w, dtype=np.float32) + 0.5) * (w / out_w) - 0.5
    ys = np.clip(ys, 0, h - 1)
    xs = np.clip(xs, 0, w - 1)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = (ys - y0)[:, None].astype(np.float32)
    wx = (xs - x0)[None, :].astype(np.float32)
    im = np.asarray(img, np.float32)
    top = im[y0][:, x0] * (1 - wx) + im[y0][:, x1] * wx
    bot = im[y1][:, x0] * (1 - wx) + im[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


# --------------------------------------------------------------------------- C++
_lib: Optional[ctypes.CDLL] = None
_lib_error: Optional[str] = None


def _load_lib() -> Optional[ctypes.CDLL]:
    """The native decoder, built at the first call; ``None`` (and the reason
    in :func:`native_error`) when it cannot be built or loaded. One attempt per
    process."""
    global _lib, _lib_error
    if _lib is not None or _lib_error is not None:
        return _lib
    from vaegan_tpu_torch.ops import _build

    try:
        lib = ctypes.CDLL(str(_build.build_host()))
    except (OSError, RuntimeError) as e:
        _lib_error = str(e)
        return None
    lib.nifti_decode_resize.restype = ctypes.c_int
    lib.nifti_decode_resize.argtypes = [
        ctypes.c_char_p,                    # path
        ctypes.POINTER(ctypes.c_float),     # out buffer (out_h*out_w)
        ctypes.c_int, ctypes.c_int,         # out_h, out_w
        ctypes.c_int,                       # normalize (minmax) flag
    ]
    lib.nifti_decode_batch.restype = ctypes.c_int
    lib.nifti_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,   # paths, count
        ctypes.POINTER(ctypes.c_float),                  # out (count*out_h*out_w)
        ctypes.c_int, ctypes.c_int,                      # out_h, out_w
        ctypes.c_int, ctypes.c_int,                      # normalize, threads
    ]
    lib.nifti_last_error.restype = ctypes.c_char_p
    _lib = lib
    return _lib


def have_native() -> bool:
    return _load_lib() is not None


def native_error() -> Optional[str]:
    """Why the native decoder is not available (the build's output), or ``None``."""
    _load_lib()
    return _lib_error


def load_image(path: Union[str, Path], image_size: int, normalize: bool = True,
               use_native: bool = True) -> np.ndarray:
    """One image through the reference pipeline: decode -> min-max normalize to
    [0, 1] -> bilinear resize -> (H, W, 1) float32. The C++ path when it builds."""
    lib = _load_lib() if use_native else None
    if lib is not None:
        out = np.empty((image_size, image_size), np.float32)
        rc = lib.nifti_decode_resize(
            str(path).encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            image_size, image_size, int(normalize))
        if rc != 0:
            raise ValueError(f"{path}: {lib.nifti_last_error().decode()}")
        return out[..., None]
    img = read_nifti(path)
    img = np.squeeze(img)
    if img.ndim != 2:
        raise ValueError(
            f"{path}: expected a 2-D image after squeezing, got shape {img.shape} — "
            "the pipeline (like the reference's hand X-rays) is 2-D; slice volumes "
            "upstream")
    if normalize:
        lo, hi = float(img.min()), float(img.max())
        img = (img - lo) / max(hi - lo, 1e-12)
    img = resize_bilinear(img, image_size, image_size)
    return img[..., None].astype(np.float32)
