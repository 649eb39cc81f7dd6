"""Fused kernels of the port (counterpart of ``vaegan_tpu/ops/pallas_fused.py``).

Each TPU kernel of the JAX package is a hand-written CUDA kernel (``sm_90a``)
under ``csrc/``, built at first use and bound with ctypes:

- ``bn_act_dropout``: BatchNorm-normalize + LeakyReLU + inverted dropout, forward
  and backward (``csrc/bn_act_dropout.cu``);
- ``reparam_kl``: z = mu + exp(lv / 2) * eps with eps drawn in the kernel, plus
  the summed KL, forward and backward (``csrc/reparam_kl.cu``);
- ``recon_loss_sums``: (sum |r - t|, sum (r - t)^2) in one pass
  (``csrc/recon_loss_sums.cu``); its backward is plain PyTorch, as the JAX
  package's is plain jnp.

Beside each kernel wrapper (``*_forward``, ``*_backward``) is its plain PyTorch
version (``*_reference``), with the same arithmetic in the same order and the
same random bits. A wrapper picks by the tensor's device: a CPU tensor goes to
the plain version (that is how the CPU tests run), a CUDA tensor launches the
kernel or raises — there is no fallback. ``bn_act_dropout``, ``reparam_kl`` and
``recon_loss_sums`` are the differentiable ``torch.autograd.Function``s the
models call; their backwards are once-differentiable, so a grad-of-grad (the
WGAN gradient penalty) cannot run through them.

Layout: activations are (N, C, H, W) tensors in ``torch.channels_last`` memory
format, i.e. NHWC buffers; a kernel sees the row-major (N*H*W, C) matrix the TPU
kernel saw, and indexes random bits by the flat NHWC position. Random bits are
Philox4x32-10 keyed on (seed lo, seed hi), with the counter's third word naming
the stream:

- dropout: counter (index // 4, 0), word ``index % 4``; the element is kept when
  ``float(bits >> 8) >= p * 2**24`` (the TPU kernel's rule);
- reparam noise: counter (index // 2, 1), words ``2 (index % 2)`` and
  ``2 (index % 2) + 1`` as the Box-Muller pair (b1, b2):
  ``u1 = ((b1 >> 8) + 1) / 2**24``, ``u2 = (b2 >> 8) / 2**24``,
  ``eps = sqrt(-2 log u1) cos(2 pi u2)`` (the TPU kernel's rule).

``LAUNCHES`` counts kernel launches per kernel name: one is added where a
wrapper launches its kernel, and nowhere else. Channel and block sums are taken
in a fixed order on the card (no float atomics), so a kernel gives the same bits
run to run. The ``bn_act_dropout`` backward, the ``reparam_kl`` forward and
``recon_loss_sums`` reduce over their grid in the same launch
(``csrc/grid_reduce.cuh``): they run in thread-block clusters of
:data:`CLUSTER` blocks, write one row of sums per
cluster to scratch, and the last cluster to draw a ticket from a counter in
device memory adds the rows. The counter is kept per CUDA stream
(:func:`_ticket`), since launches on one stream never overlap.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from vaegan_tpu_torch.ops import _build

LAUNCHES: Dict[str, int] = {"bn_act_dropout": 0, "bn_act_dropout_bwd": 0,
                            "reparam_kl": 0, "reparam_kl_bwd": 0, "recon_loss_sums": 0}

# the backward folds a block's channel sums in shared memory: blockDim * 4 (or 1)
# elements must span a multiple of C within 1024 threads
MAX_CHANNELS = 1024

_MASK32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_STREAM_DROPOUT, _STREAM_REPARAM = 0, 1
_TWO_POW_M24 = 2.0 ** -24
_TWO_PI = float(np.float32(2.0 * np.pi))

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LC = ctypes.c_longlong
_P = ctypes.c_void_p


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


def _philox_words(count: int, stream: int, seed: int, device):
    """The four words of counters (i, stream) for i in [0, count)."""
    i = torch.arange(count, dtype=torch.int64, device=device)
    zero = torch.zeros_like(i)
    return philox4x32_10(i & _MASK32, i >> 32, zero + stream, zero,
                         seed & _MASK32, (seed >> 32) & _MASK32)


def dropout_bits(numel: int, seed: int, device) -> torch.Tensor:
    """The 32-bit random word of every flat index in [0, numel), as int64."""
    words = _philox_words((numel + 3) // 4, _STREAM_DROPOUT, seed, device)
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


def reparam_noise(shape, seed: int, device) -> torch.Tensor:
    """The reparameterization noise of an (N, C, H, W) channels_last tensor of
    ``shape``: float32 N(0, 1), a pure function of (seed, flat NHWC index)."""
    n, c, h, w = shape
    numel = n * c * h * w
    w0, w1, w2, w3 = _philox_words((numel + 1) // 2, _STREAM_REPARAM, seed, device)
    b1 = torch.stack((w0, w2), dim=1).reshape(-1)[:numel]
    b2 = torch.stack((w1, w3), dim=1).reshape(-1)[:numel]
    u1 = ((b1 >> 8).to(torch.float32) + 1.0) * _TWO_POW_M24
    u2 = (b2 >> 8).to(torch.float32) * _TWO_POW_M24
    eps = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI * u2)
    return eps.view(n, h, w, c).permute(0, 3, 1, 2)


# ---------------------------------------------------------------------------
# kernel binding
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _kernel_fn(lib: str, name: str, argtypes: Tuple):
    fn = getattr(_build.library(lib), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def _device_kind(t: torch.Tensor, what: str) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{what} runs on cuda or cpu tensors, got {t.device}")
    return t.device.type


def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed with CUDA error {rc}")


def _channels_last(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last)


def _check_cotangent(what: str, name: str, g: torch.Tensor, like: torch.Tensor) -> None:
    """A backward kernel reads as many elements of the cotangent as its input has,
    on the input's device."""
    if g.shape != like.shape or g.device != like.device:
        raise ValueError(f"{what}: {name} must have the shape {tuple(like.shape)} and the "
                         f"device {like.device} of its input, got {tuple(g.shape)} on {g.device}")


# ---------------------------------------------------------------------------
# one-launch grid reductions (csrc/grid_reduce.cuh)
# ---------------------------------------------------------------------------

# blocks per thread-block cluster: the portable maximum on Hopper
CLUSTER = 8


class LaunchShape(NamedTuple):
    """A kernel launch of ``blocks`` blocks (a multiple of :data:`CLUSTER`) of
    ``threads`` threads with ``vec`` elements per thread slot."""
    threads: int
    vec: int
    blocks: int

    @property
    def clusters(self) -> int:
        return self.blocks // CLUSTER


def _cluster_grid(n: int, per_block: int, max_clusters: int) -> int:
    """Blocks for ``n`` elements at ``per_block`` elements a block per pass: whole
    clusters, no more than the elements need and at most ``max_clusters`` (the
    clusters that fit on the card at once, so the grid runs as one wave), at
    least one cluster (blocks with nothing to do add zeros)."""
    return CLUSTER * max(1, min(-(-n // (per_block * CLUSTER)), max_clusters))


@functools.lru_cache(maxsize=None)
def _max_clusters(lib: str, name: str, device_index, *args) -> int:
    """How many clusters of a kernel fit on the current device at once
    (``cudaOccupancyMaxActiveClusters``, at least 1), asked once per device and
    kernel."""
    fn = _kernel_fn(lib, name, (ctypes.c_int,) * len(args))
    n = fn(*args)
    if n < 0:
        raise RuntimeError(f"{name} failed with CUDA error {-n}")
    if n == 0:
        raise RuntimeError(f"{name}: no cluster of the kernel fits on the device")
    return n


def _reduction_scratch(shape: LaunchShape, width: int, device) -> torch.Tensor:
    """Global scratch of a one-launch reduction: one row of ``width`` floats per
    cluster."""
    return torch.empty((shape.clusters, width), dtype=torch.float32, device=device)


# (device, stream) -> int32 ticket counter of the grid reductions on that stream
_TICKETS: Dict[Tuple[str, int], torch.Tensor] = {}


def _ticket(device, stream: int) -> torch.Tensor:
    """The ticket counter of the one-launch reductions on ``stream`` of
    ``device``. It is zeroed once, when made, on that stream; every kernel that
    draws tickets from it leaves it at 0, so the next launch needs no memset.
    Kernels on one stream run one after another and share a counter; kernels on
    two streams may run at once, so each stream has its own."""
    key = (str(torch.device(device)), stream)
    t = _TICKETS.get(key)
    if t is None:
        t = _TICKETS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return t


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


def _ch(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def bn_act_dropout_reference(x, mean, var, scale, bias, seed: int, slope: float,
                             p: float, eps: float = 1e-5) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: the same steps in the same
    order, each rounded to f32, and the same Philox mask."""
    _check(x, mean, var, scale, bias, seed, p)
    inv = torch.rsqrt(var + eps)
    mul = _ch(inv * scale)
    a = (x.float() - _ch(mean)) * mul + _ch(bias)
    y = torch.where(a > 0, a, a * slope)
    if p > 0.0:
        y = torch.where(keep_mask(x, seed, p), y * keep_scale(p), torch.zeros((), device=x.device))
    return _channels_last(y.to(x.dtype))


def bn_act_dropout_forward(x, mean, var, scale, bias, seed: int, slope: float, p: float,
                           eps: float = 1e-5) -> torch.Tensor:
    """y = dropout_p(leaky_relu(scale * (x - mean) * rsqrt(var + eps) + bias, slope)).

    ``x``: (N, C, H, W) float32/bfloat16 in channels_last memory format;
    ``mean``/``var``/``scale``/``bias``: contiguous float32 (C,); ``seed``: int in
    [0, 2**64), the dropout stream is a pure function of (seed, flat NHWC index).
    """
    if _device_kind(x, "bn_act_dropout") == "cpu":
        return bn_act_dropout_reference(x, mean, var, scale, bias, seed, slope, p, eps)
    _check(x, mean, var, scale, bias, seed, p)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    fn = _kernel_fn("bn_act_dropout", "vaegan_bn_act_dropout_fwd", (_P,) * 6 + (
        _LC, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_ulonglong, ctypes.c_int, _P))
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), y.data_ptr(), mean.data_ptr(), var.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), x.numel(), x.shape[1], _DTYPE_CODE[x.dtype], slope, eps,
                int(p > 0.0), keep_threshold(p), keep_scale(p) if p > 0.0 else 1.0, seed,
                _sms(x.device) * 8, _stream(x.device))
    _raise_on(rc, "bn_act_dropout")
    LAUNCHES["bn_act_dropout"] += 1
    return y


def bn_act_dropout_backward_reference(x, g, mean, var, scale, bias, seed: int, slope: float,
                                      p: float, eps: float = 1e-5):
    """Plain PyTorch version of the backward kernel: the forward's mask replayed,
    ga = leaky'(a) * mask * g / (1 - p), then ``(dx, dscale, dbias, dmean, dvar)``
    with dx = ga * scale * inv, dscale = sum ga * xhat, dbias = sum ga,
    dmean = -inv * scale * sum ga, dvar = -0.5 * scale * sum(ga * xhat) / (var + eps)."""
    _check(x, mean, var, scale, bias, seed, p)
    inv = torch.rsqrt(var + eps)
    d = x.float() - _ch(mean)
    a = d * _ch(inv * scale) + _ch(bias)
    xhat = d * _ch(inv)
    gl = g.to(x.dtype).float()
    if p > 0.0:
        gl = torch.where(keep_mask(x, seed, p), gl * keep_scale(p),
                         torch.zeros((), device=x.device))
    ga = torch.where(a > 0, gl, gl * slope)
    dx = _channels_last(((ga * _ch(scale)) * _ch(inv)).to(x.dtype))
    sum_ga = ga.sum(dim=(0, 2, 3))
    sum_gx = (ga * xhat).sum(dim=(0, 2, 3))
    dmean = (scale * sum_ga) * (-inv)
    dvar = ((scale * sum_gx) * -0.5) / (var + eps)
    return dx, sum_gx, sum_ga, dmean, dvar


def _bwd_block(c: int) -> Tuple[int, int]:
    """(threads, elements per thread) of the backward kernel: a block's threads *
    elements must span a multiple of C, so each thread always meets the same
    channels and keeps their sums in registers."""
    if 1024 % c == 0:
        return 256, 4
    return c * (1024 // c), 1


def _bwd_launch_shape(c: int, n: int, max_clusters: int) -> LaunchShape:
    """The backward kernel's launch for C channels and n elements, at most
    ``max_clusters`` clusters."""
    threads, vec = _bwd_block(c)
    return LaunchShape(threads, vec, _cluster_grid(n, threads * vec, max_clusters))


def bwd_launch_for(x: torch.Tensor, p: float) -> LaunchShape:
    """The backward kernel's launch for the CUDA tensor ``x`` at dropout ``p``."""
    c = x.shape[1]
    threads, vec = _bwd_block(c)
    with torch.cuda.device(x.device):
        fits = _max_clusters("bn_act_dropout", "vaegan_bn_act_dropout_bwd_max_clusters",
                             x.device.index, c, _DTYPE_CODE[x.dtype], int(p > 0.0), threads,
                             vec, CLUSTER)
    return _bwd_launch_shape(c, x.numel(), fits)


def bn_act_dropout_backward(x, g, mean, var, scale, bias, seed: int, slope: float,
                            p: float, eps: float = 1e-5):
    """The forward's gradient: ``(dx, dscale, dbias, dmean, dvar)`` for the
    upstream gradient ``g`` of y (any memory format; made channels_last), with the
    forward's dropout mask replayed from ``seed``. One kernel launch; channel sums
    are deterministic."""
    _check_cotangent("bn_act_dropout backward", "g", g, x)
    g = _channels_last(g.to(x.dtype))
    if _device_kind(x, "bn_act_dropout backward") == "cpu":
        return bn_act_dropout_backward_reference(x, g, mean, var, scale, bias, seed, slope,
                                                 p, eps)
    _check(x, mean, var, scale, bias, seed, p)
    c = x.shape[1]
    shape = bwd_launch_for(x, p)
    with torch.cuda.device(x.device):
        dx = torch.empty_like(x, memory_format=torch.channels_last)
        rows = _reduction_scratch(shape, 2 * c, x.device)
        grads = torch.empty((4, c), dtype=torch.float32, device=x.device)
        dscale, dbias, dmean, dvar = grads.unbind(0)
        stream = _stream(x.device)
        fn = _kernel_fn("bn_act_dropout", "vaegan_bn_act_dropout_bwd", (_P,) * 13 + (
            _LC, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_ulonglong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, _P))
        rc = fn(x.data_ptr(), g.data_ptr(), dx.data_ptr(), rows.data_ptr(),
                _ticket(x.device, stream).data_ptr(), mean.data_ptr(), var.data_ptr(),
                scale.data_ptr(), bias.data_ptr(), dscale.data_ptr(), dbias.data_ptr(),
                dmean.data_ptr(), dvar.data_ptr(), x.numel(), c, _DTYPE_CODE[x.dtype], slope,
                eps, int(p > 0.0), keep_threshold(p), keep_scale(p) if p > 0.0 else 1.0, seed,
                shape.threads, shape.vec, shape.blocks, CLUSTER, stream)
    _raise_on(rc, "bn_act_dropout backward")
    LAUNCHES["bn_act_dropout_bwd"] += 1
    return dx, dscale, dbias, dmean, dvar


class _BnActDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mean, var, scale, bias, seed, slope, p, eps):
        ctx.save_for_backward(x, mean, var, scale, bias)
        ctx.args = (seed, slope, p, eps)
        return bn_act_dropout_forward(x, mean, var, scale, bias, seed, slope, p, eps)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        x, mean, var, scale, bias = ctx.saved_tensors
        dx, dscale, dbias, dmean, dvar = bn_act_dropout_backward(
            x, gy, mean, var, scale, bias, *ctx.args)
        return dx, dmean, dvar, dscale, dbias, None, None, None, None


def bn_act_dropout(x, mean, var, scale, bias, seed: int, slope: float, p: float,
                   eps: float = 1e-5) -> torch.Tensor:
    """Differentiable :func:`bn_act_dropout_forward`: the backward kernel gives
    the gradients of x, mean, var, scale and bias (autograd carries dmean and dvar
    into the batch statistics when they were computed from x)."""
    return _BnActDropout.apply(x, mean, var, scale, bias, seed, slope, p, eps)


# ---------------------------------------------------------------------------
# reparam_kl
# ---------------------------------------------------------------------------

def _check_reparam(mu, lv, seed) -> None:
    if mu.dim() != 4 or mu.shape != lv.shape:
        raise ValueError(f"reparam_kl takes two (N, C, H, W) tensors of one shape, got "
                         f"{tuple(mu.shape)} and {tuple(lv.shape)}")
    if mu.dtype not in _DTYPE_CODE or lv.dtype != mu.dtype or lv.device != mu.device:
        raise TypeError(f"reparam_kl takes float32 or bfloat16 mu and log_var of one dtype "
                        f"and device, got {mu.dtype}/{lv.dtype} on {mu.device}/{lv.device}")
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed must be in [0, 2**64), got {seed}")


def reparam_kl_reference(mu, lv, seed: int):
    """Plain PyTorch version of the forward kernel: ``(z, kl)`` with the same
    Philox noise and the same per-element arithmetic."""
    _check_reparam(mu, lv, seed)
    eps = reparam_noise(mu.shape, seed, mu.device)
    m, l = mu.float(), lv.float()
    z = _channels_last((m + torch.exp(0.5 * l) * eps).to(mu.dtype))
    kl = -0.5 * torch.sum(((1.0 + l) - m * m) - torch.exp(l))
    return z, kl


def _reparam_launch_shape(n: int, max_clusters: int) -> LaunchShape:
    """The forward kernel's launch for n elements (256 threads of 4 elements a
    block), at most ``max_clusters`` clusters."""
    return LaunchShape(256, 4, _cluster_grid(n, 1024, max_clusters))


def reparam_launch_for(mu: torch.Tensor) -> LaunchShape:
    """The forward kernel's launch for the CUDA tensor ``mu``."""
    with torch.cuda.device(mu.device):
        fits = _max_clusters("reparam_kl", "vaegan_reparam_kl_fwd_max_clusters",
                             mu.device.index, _DTYPE_CODE[mu.dtype], CLUSTER)
    return _reparam_launch_shape(mu.numel(), fits)


def reparam_kl_forward(mu, lv, seed: int):
    """``(z, kl)``: z = mu + exp(lv / 2) * eps with eps ~ N(0, 1) drawn in the
    kernel from (seed, flat NHWC index), and the KL summed over batch and dims
    (an f32 scalar) in the same launch. ``mu``/``lv``: (N, C, H, W)
    float32/bfloat16, made channels_last."""
    mu, lv = _channels_last(mu), _channels_last(lv)
    if _device_kind(mu, "reparam_kl") == "cpu":
        return reparam_kl_reference(mu, lv, seed)
    _check_reparam(mu, lv, seed)
    shape = reparam_launch_for(mu)
    with torch.cuda.device(mu.device):
        z = torch.empty_like(mu, memory_format=torch.channels_last)
        rows = _reduction_scratch(shape, 1, mu.device)
        kl = torch.empty((), dtype=torch.float32, device=mu.device)
        stream = _stream(mu.device)
        fn = _kernel_fn("reparam_kl", "vaegan_reparam_kl_fwd", (_P,) * 6 + (
            _LC, ctypes.c_int, ctypes.c_ulonglong, ctypes.c_int, ctypes.c_int, _P))
        rc = fn(mu.data_ptr(), lv.data_ptr(), z.data_ptr(), rows.data_ptr(),
                _ticket(mu.device, stream).data_ptr(), kl.data_ptr(), mu.numel(),
                _DTYPE_CODE[mu.dtype], seed, shape.blocks, CLUSTER, stream)
    _raise_on(rc, "reparam_kl")
    LAUNCHES["reparam_kl"] += 1
    return z, kl


def reparam_kl_backward_reference(mu, lv, gz, gkl, seed: int):
    """Plain PyTorch version of the backward kernel: ``(dmu, dlv)`` with the
    forward's noise replayed; ``gkl`` None counts as 0."""
    _check_reparam(mu, lv, seed)
    eps = reparam_noise(mu.shape, seed, mu.device)
    m, l, g = mu.float(), lv.float(), gz.float()
    k = torch.zeros((), device=mu.device) if gkl is None else gkl.float()
    dmu = g + k * m
    dlv = ((g * 0.5) * torch.exp(0.5 * l)) * eps + (k * -0.5) * (1.0 - torch.exp(l))
    return _channels_last(dmu.to(mu.dtype)), _channels_last(dlv.to(lv.dtype))


def reparam_kl_backward(mu, lv, gz, gkl: Optional[torch.Tensor], seed: int):
    """The forward's gradient ``(dmu, dlv)`` for the cotangents ``gz`` of z and
    ``gkl`` of the KL (a scalar tensor, or None for 0: the training step's loss
    recomputes the KL, so this output is unused there)."""
    mu, lv = _channels_last(mu), _channels_last(lv)
    _check_cotangent("reparam_kl backward", "gz", gz, mu)
    gz = _channels_last(gz.to(mu.dtype))
    if gkl is not None:
        if gkl.numel() != 1 or gkl.device != mu.device:
            raise ValueError(f"reparam_kl backward: gkl must be one value on {mu.device}, got "
                             f"shape {tuple(gkl.shape)} on {gkl.device}")
        gkl = gkl.detach().to(torch.float32).reshape(())
    if _device_kind(mu, "reparam_kl backward") == "cpu":
        return reparam_kl_backward_reference(mu, lv, gz, gkl, seed)
    _check_reparam(mu, lv, seed)
    n = mu.numel()
    dmu = torch.empty_like(mu, memory_format=torch.channels_last)
    dlv = torch.empty_like(lv, memory_format=torch.channels_last)
    fn = _kernel_fn("reparam_kl", "vaegan_reparam_kl_bwd", (_P,) * 6 + (
        _LC, ctypes.c_int, ctypes.c_ulonglong, ctypes.c_int, _P))
    with torch.cuda.device(mu.device):
        rc = fn(mu.data_ptr(), lv.data_ptr(), gz.data_ptr(),
                None if gkl is None else gkl.data_ptr(), dmu.data_ptr(), dlv.data_ptr(), n,
                _DTYPE_CODE[mu.dtype], seed, _sms(mu.device) * 8, _stream(mu.device))
    _raise_on(rc, "reparam_kl backward")
    LAUNCHES["reparam_kl_bwd"] += 1
    return dmu, dlv


class _ReparamKL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mu, lv, seed):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(mu, lv)
        ctx.seed = seed
        return reparam_kl_forward(mu, lv, seed)

    @staticmethod
    @once_differentiable
    def backward(ctx, gz, gkl):
        mu, lv = ctx.saved_tensors
        if gz is None:
            gz = torch.zeros_like(mu)
        dmu, dlv = reparam_kl_backward(mu, lv, gz, gkl, ctx.seed)
        return dmu, dlv, None


def reparam_kl(mu, log_var, seed: int):
    """Differentiable :func:`reparam_kl_forward`: ``(z, kl)``."""
    return _ReparamKL.apply(mu, log_var, seed)


# ---------------------------------------------------------------------------
# recon_loss_sums
# ---------------------------------------------------------------------------

def _check_recon(r, t) -> None:
    if r.shape != t.shape or r.dtype != t.dtype or r.device != t.device:
        raise ValueError(f"recon_loss_sums takes two tensors of one shape, dtype and device, "
                         f"got {tuple(r.shape)} {r.dtype} {r.device} and "
                         f"{tuple(t.shape)} {t.dtype} {t.device}")
    if r.dtype not in _DTYPE_CODE:
        raise TypeError(f"recon_loss_sums takes float32 or bfloat16, got {r.dtype}")
    if r.numel() == 0:
        raise ValueError("recon_loss_sums takes non-empty tensors")


def recon_loss_sums_reference(r, t) -> torch.Tensor:
    """Plain PyTorch version: (sum |r - t|, sum (r - t)^2) in float32."""
    _check_recon(r, t)
    d = r.float() - t.float()
    return torch.stack((d.abs().sum(), (d * d).sum()))


def _recon_launch_shape(n: int, max_clusters: int) -> LaunchShape:
    """The kernel's launch for n elements (256 threads of 8 elements a block per
    pass), at most ``max_clusters`` clusters."""
    return LaunchShape(256, 8, _cluster_grid(n, 256 * 8, max_clusters))


def recon_launch_for(r: torch.Tensor) -> LaunchShape:
    """The kernel's launch for the CUDA tensor ``r``."""
    with torch.cuda.device(r.device):
        fits = _max_clusters("recon_loss_sums", "vaegan_recon_loss_sums_max_clusters",
                             r.device.index, _DTYPE_CODE[r.dtype], CLUSTER)
    return _recon_launch_shape(r.numel(), fits)


def recon_loss_sums_forward(r, t) -> torch.Tensor:
    """(sum |r - t|, sum (r - t)^2) as a float32 (2,) tensor, in one pass over
    both (made contiguous in their given layout) and one launch."""
    r, t = r.contiguous(), t.contiguous()
    if _device_kind(r, "recon_loss_sums") == "cpu":
        return recon_loss_sums_reference(r, t)
    _check_recon(r, t)
    shape = recon_launch_for(r)
    with torch.cuda.device(r.device):
        rows = _reduction_scratch(shape, 2, r.device)
        out = torch.empty(2, dtype=torch.float32, device=r.device)
        stream = _stream(r.device)
        fn = _kernel_fn("recon_loss_sums", "vaegan_recon_loss_sums", (_P,) * 5 + (
            _LC, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P))
        rc = fn(r.data_ptr(), t.data_ptr(), rows.data_ptr(), _ticket(r.device, stream).data_ptr(),
                out.data_ptr(), r.numel(), _DTYPE_CODE[r.dtype], shape.blocks, CLUSTER, stream)
    _raise_on(rc, "recon_loss_sums")
    LAUNCHES["recon_loss_sums"] += 1
    return out


class _ReconLossSums(torch.autograd.Function):
    @staticmethod
    def forward(ctx, r, t):
        ctx.save_for_backward(r, t)
        return recon_loss_sums_forward(r, t)

    @staticmethod
    def backward(ctx, g):
        # plain PyTorch, as the JAX package's _recon_bwd is plain jnp:
        # d/dr [g0 sum |d| + g1 sum d^2] = g0 sign(d) + 2 g1 d
        r, t = ctx.saved_tensors
        d = r.float() - t.float()
        dr = g[0] * torch.sign(d) + g[1] * 2.0 * d
        return (dr.to(r.dtype) if ctx.needs_input_grad[0] else None,
                (-dr).to(t.dtype) if ctx.needs_input_grad[1] else None)


def recon_loss_sums(recon, target) -> torch.Tensor:
    """Differentiable :func:`recon_loss_sums_forward`; divide by the element
    count for the mean-reduced L1 + MSE of the reference."""
    return _ReconLossSums.apply(recon, target)
