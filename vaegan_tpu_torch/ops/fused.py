"""Fused kernels of the port (counterpart of ``vaegan_tpu/ops/pallas_fused.py``).

``bn_act_dropout``: BatchNorm-normalize + LeakyReLU + inverted dropout in one
pass, the hand-written CUDA kernel ``csrc/bn_act_dropout.cu`` (``sm_90a``).
Beside it is its plain PyTorch version, ``bn_act_dropout_reference``, with the
same arithmetic in the same order and the same random bits. The wrapper picks by
the tensor's device: a CPU tensor goes to the plain version (that is how the CPU
tests run), a CUDA tensor launches the kernel or raises — there is no fallback.

Layout: ``x`` is an (N, C, H, W) tensor in ``torch.channels_last`` memory format,
i.e. an NHWC buffer; the kernel sees it as the row-major (N*H*W, C) matrix the
TPU kernel saw. The dropout mask is a pure function of (seed, flat NHWC index):
Philox4x32-10 with key (seed lo, seed hi) and counter (index // 4 lo, hi, 0, 0)
gives four 32-bit words, word ``index % 4`` belongs to the element, and the
element is kept when ``float(bits >> 8) >= p * 2**24`` (the TPU kernel's rule).

``LAUNCHES`` counts kernel launches per kernel name: one is added where the
kernel is launched, and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from vaegan_tpu_torch.ops import _build

LAUNCHES: Dict[str, int] = {"bn_act_dropout": 0}

# the shared-memory table holds 3 f32 per channel within the default 48 KB
MAX_CHANNELS = 4096

_MASK32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# Philox4x32-10 on int64 tensors (each value holds one unsigned 32-bit word)
# ---------------------------------------------------------------------------

def _mulhilo(m: int, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of the 64-bit product m * b. The product is taken in
    16-bit halves of b so no int64 intermediate exceeds 2**49 (a full 32x32
    product would wrap a signed int64)."""
    p_lo = m * (b & 0xFFFF)
    p_hi = m * (b >> 16)
    mid = p_hi + (p_lo >> 16)
    return mid >> 16, ((mid & 0xFFFF) << 16) | (p_lo & 0xFFFF)


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 (Salmon et al., SC'11) over int64 tensors of 32-bit words."""
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W0) & _MASK32
            k1 = (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def dropout_bits(numel: int, seed: int, device) -> torch.Tensor:
    """The 32-bit random word of every flat index in [0, numel), as int64."""
    g = torch.arange((numel + 3) // 4, dtype=torch.int64, device=device)
    zero = torch.zeros_like(g)
    words = philox4x32_10(g & _MASK32, g >> 32, zero, zero,
                          seed & _MASK32, (seed >> 32) & _MASK32)
    return torch.stack(words, dim=1).reshape(-1)[:numel]


def keep_threshold(p: float) -> float:
    """The f32 threshold of the keep rule ``float(bits >> 8) >= p * 2**24``."""
    return float(np.float32(p * (1 << 24)))


def keep_scale(p: float) -> float:
    """The f32 factor 1 / (1 - p) applied to kept values."""
    return float(np.float32(1.0 / (1.0 - p)))


def keep_mask(x: torch.Tensor, seed: int, p: float) -> torch.Tensor:
    """Bool keep-mask of the channels_last (N, C, H, W) ``x``, indexed by each
    element's flat NHWC position."""
    n, c, h, w = x.shape
    u24 = (dropout_bits(x.numel(), seed, x.device) >> 8).to(torch.float32)
    keep = u24 >= keep_threshold(p)
    return keep.view(n, h, w, c).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# bn_act_dropout
# ---------------------------------------------------------------------------

def _check(x, mean, var, scale, bias, seed, p) -> None:
    if x.dim() != 4:
        raise ValueError(f"bn_act_dropout takes an (N, C, H, W) tensor, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"bn_act_dropout takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("bn_act_dropout needs x in torch.channels_last memory format "
                         f"(strides {x.stride()} for shape {tuple(x.shape)})")
    c = x.shape[1]
    if c > MAX_CHANNELS:
        raise ValueError(f"bn_act_dropout supports at most {MAX_CHANNELS} channels, got {c}")
    for name, v in (("mean", mean), ("var", var), ("scale", scale), ("bias", bias)):
        if v.shape != (c,) or v.dtype != torch.float32 or v.device != x.device \
                or not v.is_contiguous():
            raise ValueError(f"bn_act_dropout: {name} must be a contiguous float32 ({c},) "
                             f"tensor on {x.device}, got {tuple(v.shape)} {v.dtype} on {v.device}")
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout p must be in [0, 1), got {p}")
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed must be in [0, 2**64), got {seed}")


def bn_act_dropout_reference(x, mean, var, scale, bias, seed: int, slope: float,
                             p: float, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the same steps in the same order,
    each rounded to f32, and the same Philox mask."""
    _check(x, mean, var, scale, bias, seed, p)
    inv = torch.rsqrt(var + eps)
    mul = (inv * scale).view(1, -1, 1, 1)
    a = (x.float() - mean.view(1, -1, 1, 1)) * mul + bias.view(1, -1, 1, 1)
    y = torch.where(a > 0, a, a * slope)
    if p > 0.0:
        y = torch.where(keep_mask(x, seed, p), y * keep_scale(p), torch.zeros((), device=x.device))
    return y.to(x.dtype).contiguous(memory_format=torch.channels_last)


@functools.lru_cache(maxsize=None)
def _kernel_fn():
    fn = _build.library("bn_act_dropout").vaegan_bn_act_dropout_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_ulonglong, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bn_act_dropout(x, mean, var, scale, bias, seed: int, slope: float, p: float,
                   eps: float = 1e-5) -> torch.Tensor:
    """y = dropout_p(leaky_relu(scale * (x - mean) * rsqrt(var + eps) + bias, slope)).

    ``x``: (N, C, H, W) float32/bfloat16 in channels_last memory format;
    ``mean``/``var``/``scale``/``bias``: contiguous float32 (C,); ``seed``: int in
    [0, 2**64), the dropout stream is a pure function of (seed, flat NHWC index).
    Forward only: the backward kernel comes with the training path.
    """
    if x.device.type == "cpu":
        return bn_act_dropout_reference(x, mean, var, scale, bias, seed, slope, p, eps)
    if x.device.type != "cuda":
        raise RuntimeError(f"bn_act_dropout runs on cuda or cpu tensors, got {x.device}")
    _check(x, mean, var, scale, bias, seed, p)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    with torch.cuda.device(x.device):
        rc = _kernel_fn()(
            x.data_ptr(), y.data_ptr(), mean.data_ptr(), var.data_ptr(), scale.data_ptr(),
            bias.data_ptr(), x.numel(), x.shape[1], _DTYPE_CODE[x.dtype], slope, eps,
            int(p > 0.0), keep_threshold(p), keep_scale(p) if p > 0.0 else 1.0, seed,
            sms * 8, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bn_act_dropout kernel launch failed with CUDA error {rc}")
    LAUNCHES["bn_act_dropout"] += 1
    return y
