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

The index is the element's place in the global tensor of a parallel step:
rows 1-4 take an index map ``(base, stripe)``, local flat element e being
global element ``base + (e // L) G + e % L`` for ``stripe = (L, G)``, the
local and the global elements of an image (a process's H stripe of an image is
a run of L of its G), and ``base + e`` for ``stripe=None`` (whole images:
L = G). So a parallel process draws its part of the stream the one-process
step draws over the global batch (``ops.replica.Replica.index_map``); base 0
with no stripe is the one-process draw. ``base`` is a multiple of 4 (one
Philox call's words); a stripe's L and G are multiples of 4 for the dropout
stream and of 2 for the noise, so that one call's words fall in one image.
Each of the four kernels is built in two instances: a stripe map (L < G)
launches the striped one (rows 1-3 divide by L in its loop; row 4 carries
its global index from pass to pass), every other map the contiguous one, whose
loop computes ``base + e`` alone. Row 4 also comes with and without a KL
cotangent: ``gkl=None`` leaves out e^lv where that changes no bit.

``LAUNCHES`` counts kernel launches per kernel name: one is added where a
wrapper launches its kernel, and nowhere else. While :func:`counting` runs,
a cost count (``utils.cost_analysis``) is told of every kernel call, with the
bytes and operations :func:`kernel_cost` gives it: beside ``LAUNCHES`` where a
wrapper launches, and in place of the plain version's own ops on a CPU tensor.
Outside a count a launch does one test more. The forward of ``bn_act_dropout`` is also the registered operator
``torch.ops.vaegan.bn_act_dropout`` (:func:`bn_act_dropout_op`), which is
what ``torch.export`` records: an exported program launches the same kernel
when it runs on the card. Channel and block sums are taken
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

import contextlib
import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

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


# the running cost count (:func:`counting`), or None
_COST = None


def _launched_cost(name: str, x: torch.Tensor, p: float = 0.0) -> None:
    """At a launch of kernel ``name`` on ``x``: tell the running cost count."""
    if _COST is not None:
        _COST.add(name, *_call_cost(name, x, p))


@contextlib.contextmanager
def _plain_cost(name: str, x: torch.Tensor, p: float = 0.0):
    """Around the plain version of kernel ``name`` on the CPU tensor ``x``: the
    running cost count leaves out its ops and counts the kernel's cost instead,
    so both devices count a kernel by the same formula."""
    if _COST is None:
        yield
        return
    with _COST.paused():
        yield
    _COST.add(name, *_call_cost(name, x, p))


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


def _philox_words(i: torch.Tensor, stream: int, seed: int):
    """The four words of counters (i, stream) for the int64 tensor ``i``."""
    zero = torch.zeros_like(i)
    return philox4x32_10(i & _MASK32, i >> 32, zero + stream, zero,
                         seed & _MASK32, (seed >> 32) & _MASK32)


def _check_base(base: int) -> None:
    if base < 0 or base % 4:
        raise ValueError(f"the element-index base must be a non-negative multiple of 4, "
                         f"got {base}")


def _check_map(numel: int, base: int, stripe, words: int) -> Tuple[int, int]:
    """``(L, G)`` of a valid index map (module docstring) over ``numel``
    elements, ``words`` elements a counter; ``stripe=None`` is L = G = numel."""
    _check_base(base)
    if stripe is None:
        return max(numel, 1), max(numel, 1)
    big_l, big_g = (int(v) for v in stripe)
    if big_l == big_g and big_l > 0 and numel % big_l == 0:
        return max(numel, 1), max(numel, 1)
    if big_l <= 0 or big_g < big_l or numel % big_l or big_l % words or big_g % words:
        raise ValueError(f"the index map's stripe (L={big_l}, G={big_g}) must have L dividing "
                         f"the {numel} elements and L <= G, both multiples of {words}")
    return big_l, big_g


def _counters(numel: int, words: int, base: int, stripe, device) -> torch.Tensor:
    """The Philox counter of each run of ``words`` local elements, in order,
    under the index map ``(base, stripe)``."""
    big_l, big_g = _check_map(numel, base, stripe, words)
    if big_l == big_g:
        start = base // words
        return torch.arange(start, start + (numel + words - 1) // words, dtype=torch.int64,
                            device=device)
    first = (base + torch.arange(numel // big_l, dtype=torch.int64, device=device) * big_g)
    run = torch.arange(big_l // words, dtype=torch.int64, device=device)
    return (first[:, None] // words + run[None, :]).reshape(-1)


def dropout_bits(numel: int, seed: int, device, base: int = 0, stripe=None) -> torch.Tensor:
    """The 32-bit random word of each of ``numel`` local elements under the
    index map ``(base, stripe)`` (module docstring), as int64."""
    words = _philox_words(_counters(numel, 4, base, stripe, device), _STREAM_DROPOUT, seed)
    return torch.stack(words, dim=1).reshape(-1)[:numel]


def keep_threshold(p: float) -> float:
    """The f32 threshold of the keep rule ``float(bits >> 8) >= p * 2**24``."""
    return float(np.float32(p * (1 << 24)))


def keep_scale(p: float) -> float:
    """The f32 factor 1 / (1 - p) applied to kept values."""
    return float(np.float32(1.0 / (1.0 - p)))


def keep_mask(x: torch.Tensor, seed: int, p: float, base: int = 0,
              stripe=None) -> torch.Tensor:
    """Bool keep-mask of the channels_last (N, C, H, W) ``x``, each element
    indexed by its flat NHWC position's place under ``(base, stripe)``."""
    n, c, h, w = x.shape
    u24 = (dropout_bits(x.numel(), seed, x.device, base, stripe) >> 8).to(torch.float32)
    keep = u24 >= keep_threshold(p)
    return keep.view(n, h, w, c).permute(0, 3, 1, 2)


def reparam_noise(shape, seed: int, device, base: int = 0, stripe=None) -> torch.Tensor:
    """The reparameterization noise of an (N, C, H, W) channels_last tensor of
    ``shape``: float32 N(0, 1), a pure function of seed and each element's
    global flat NHWC index under ``(base, stripe)``."""
    n, c, h, w = shape
    numel = n * c * h * w
    w0, w1, w2, w3 = _philox_words(_counters(numel, 2, base, stripe, device), _STREAM_REPARAM,
                                   seed)
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
    (``cudaOccupancyMaxActiveClusters``; or, for a kernel launched without
    clusters, blocks on one SM), at least 1, asked once per device and
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

def _check(x, mean, var, scale, bias, seed, p, base, stripe=None) -> Tuple[int, int]:
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
    return _check_map(x.numel(), base, stripe, 4)


def _ch(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def bn_act_dropout_reference(x, mean, var, scale, bias, seed: int, slope: float,
                             p: float, eps: float = 1e-5, base: int = 0,
                             stripe=None) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: the same steps in the same
    order, each rounded to f32, and the same Philox mask."""
    _check(x, mean, var, scale, bias, seed, p, base, stripe)
    inv = torch.rsqrt(var + eps)
    mul = _ch(inv * scale)
    a = (x.float() - _ch(mean)) * mul + _ch(bias)
    y = torch.where(a > 0, a, a * slope)
    if p > 0.0:
        y = torch.where(keep_mask(x, seed, p, base, stripe), y * keep_scale(p),
                        torch.zeros((), device=x.device))
    return _channels_last(y.to(x.dtype))


def bn_act_dropout_forward(x, mean, var, scale, bias, seed: int, slope: float, p: float,
                           eps: float = 1e-5, base: int = 0, stripe=None) -> torch.Tensor:
    """y = dropout_p(leaky_relu(scale * (x - mean) * rsqrt(var + eps) + bias, slope)).

    ``x``: (N, C, H, W) float32/bfloat16 in channels_last memory format;
    ``mean``/``var``/``scale``/``bias``: contiguous float32 (C,); ``seed``: int in
    [0, 2**64), the dropout stream is a pure function of seed and each element's
    global flat NHWC index under the index map ``(base, stripe)``.
    """
    if _device_kind(x, "bn_act_dropout") == "cpu":
        with _plain_cost("bn_act_dropout", x, p):
            return bn_act_dropout_reference(x, mean, var, scale, bias, seed, slope, p, eps, base,
                                            stripe)
    big_l, big_g = _check(x, mean, var, scale, bias, seed, p, base, stripe)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    fn = _kernel_fn("bn_act_dropout", "vaegan_bn_act_dropout_fwd", (_P,) * 6 + (
        _LC, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.c_float, ctypes.c_float, ctypes.c_ulonglong, _LC, _LC, _LC, ctypes.c_int, _P))
    with torch.cuda.device(x.device):
        rc = fn(x.data_ptr(), y.data_ptr(), mean.data_ptr(), var.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), x.numel(), x.shape[1], _DTYPE_CODE[x.dtype], slope, eps,
                int(p > 0.0), keep_threshold(p), keep_scale(p) if p > 0.0 else 1.0, seed,
                base, big_l, big_g, _sms(x.device) * 8, _stream(x.device))
    _raise_on(rc, "bn_act_dropout")
    LAUNCHES["bn_act_dropout"] += 1
    _launched_cost("bn_act_dropout", x, p)
    return y


def bn_act_dropout_backward_reference(x, g, mean, var, scale, bias, seed: int, slope: float,
                                      p: float, eps: float = 1e-5, base: int = 0,
                                      stripe=None):
    """Plain PyTorch version of the backward kernel: the forward's mask replayed,
    ga = leaky'(a) * mask * g / (1 - p), then ``(dx, dscale, dbias, dmean, dvar)``
    with dx = ga * scale * inv, dscale = sum ga * xhat, dbias = sum ga,
    dmean = -inv * scale * sum ga, dvar = -0.5 * scale * sum(ga * xhat) / (var + eps)."""
    _check(x, mean, var, scale, bias, seed, p, base, stripe)
    inv = torch.rsqrt(var + eps)
    d = x.float() - _ch(mean)
    a = d * _ch(inv * scale) + _ch(bias)
    xhat = d * _ch(inv)
    gl = g.to(x.dtype).float()
    if p > 0.0:
        gl = torch.where(keep_mask(x, seed, p, base, stripe), gl * keep_scale(p),
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


def bwd_launch_for(x: torch.Tensor, p: float, striped: bool = False) -> LaunchShape:
    """The backward kernel's launch for the CUDA tensor ``x`` at dropout ``p``;
    ``striped``: the kernel's instance for a stripe map (L < G)."""
    c = x.shape[1]
    threads, vec = _bwd_block(c)
    dropout = p > 0.0
    with torch.cuda.device(x.device):
        fits = _max_clusters("bn_act_dropout", "vaegan_bn_act_dropout_bwd_max_clusters",
                             x.device.index, c, _DTYPE_CODE[x.dtype], int(dropout),
                             int(dropout and striped), threads, vec, CLUSTER)
    return _bwd_launch_shape(c, x.numel(), fits)


def bn_act_dropout_backward(x, g, mean, var, scale, bias, seed: int, slope: float,
                            p: float, eps: float = 1e-5, base: int = 0, stripe=None):
    """The forward's gradient: ``(dx, dscale, dbias, dmean, dvar)`` for the
    upstream gradient ``g`` of y (any memory format; made channels_last), with the
    forward's dropout mask replayed from ``seed``. One kernel launch; channel sums
    are deterministic."""
    _check_cotangent("bn_act_dropout backward", "g", g, x)
    g = _channels_last(g.to(x.dtype))
    if _device_kind(x, "bn_act_dropout backward") == "cpu":
        with _plain_cost("bn_act_dropout_bwd", x, p):
            return bn_act_dropout_backward_reference(x, g, mean, var, scale, bias, seed, slope,
                                                     p, eps, base, stripe)
    big_l, big_g = _check(x, mean, var, scale, bias, seed, p, base, stripe)
    c = x.shape[1]
    shape = bwd_launch_for(x, p, big_l != big_g)
    with torch.cuda.device(x.device):
        dx = torch.empty_like(x, memory_format=torch.channels_last)
        rows = _reduction_scratch(shape, 2 * c, x.device)
        grads = torch.empty((4, c), dtype=torch.float32, device=x.device)
        dscale, dbias, dmean, dvar = grads.unbind(0)
        stream = _stream(x.device)
        fn = _kernel_fn("bn_act_dropout", "vaegan_bn_act_dropout_bwd", (_P,) * 13 + (
            _LC, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int,
            ctypes.c_float, ctypes.c_float, ctypes.c_ulonglong, _LC, _LC, _LC, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, _P))
        rc = fn(x.data_ptr(), g.data_ptr(), dx.data_ptr(), rows.data_ptr(),
                _ticket(x.device, stream).data_ptr(), mean.data_ptr(), var.data_ptr(),
                scale.data_ptr(), bias.data_ptr(), dscale.data_ptr(), dbias.data_ptr(),
                dmean.data_ptr(), dvar.data_ptr(), x.numel(), c, _DTYPE_CODE[x.dtype], slope,
                eps, int(p > 0.0), keep_threshold(p), keep_scale(p) if p > 0.0 else 1.0, seed,
                base, big_l, big_g, shape.threads, shape.vec, shape.blocks, CLUSTER, stream)
    _raise_on(rc, "bn_act_dropout backward")
    LAUNCHES["bn_act_dropout_bwd"] += 1
    _launched_cost("bn_act_dropout_bwd", x, p)
    return dx, dscale, dbias, dmean, dvar


class _BnActDropout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mean, var, scale, bias, seed, slope, p, eps, base, stripe):
        ctx.save_for_backward(x, mean, var, scale, bias)
        ctx.args = (seed, slope, p, eps, base, stripe)
        return bn_act_dropout_forward(x, mean, var, scale, bias, seed, slope, p, eps, base,
                                      stripe)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        x, mean, var, scale, bias = ctx.saved_tensors
        dx, dscale, dbias, dmean, dvar = bn_act_dropout_backward(
            x, gy, mean, var, scale, bias, *ctx.args)
        return dx, dmean, dvar, dscale, dbias, None, None, None, None, None, None


@torch.library.custom_op("vaegan::bn_act_dropout", mutates_args=())
def bn_act_dropout_op(x: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                      scale: torch.Tensor, bias: torch.Tensor, seed: int, slope: float,
                      p: float, eps: float, base: int,
                      stripe: Optional[List[int]]) -> torch.Tensor:
    """:func:`bn_act_dropout_forward` as a registered operator (no autograd): the
    kernel on a CUDA tensor, the plain version on a CPU one. ``seed`` is an
    int64 here, so below 2**63."""
    return bn_act_dropout_forward(x, mean, var, scale, bias, seed, slope, p, eps, base, stripe)


@bn_act_dropout_op.register_fake
def _(x, mean, var, scale, bias, seed, slope, p, eps, base, stripe):
    return torch.empty_like(x, memory_format=torch.channels_last)


def bn_act_dropout(x, mean, var, scale, bias, seed: int, slope: float, p: float,
                   eps: float = 1e-5, base: int = 0, stripe=None) -> torch.Tensor:
    """Differentiable :func:`bn_act_dropout_forward`: the backward kernel gives
    the gradients of x, mean, var, scale and bias (autograd carries dmean and dvar
    into the batch statistics when they were computed from x). Under
    ``torch.export``, which cannot trace the ctypes launch, the forward is the
    registered operator."""
    if torch.compiler.is_exporting():
        return bn_act_dropout_op(x, mean, var, scale, bias, seed, slope, p, eps, base,
                                 None if stripe is None else [int(v) for v in stripe])
    return _BnActDropout.apply(x, mean, var, scale, bias, seed, slope, p, eps, base, stripe)


# ---------------------------------------------------------------------------
# reparam_kl
# ---------------------------------------------------------------------------

def _check_reparam(mu, lv, seed, base, stripe=None) -> Tuple[int, int]:
    if mu.dim() != 4 or mu.shape != lv.shape:
        raise ValueError(f"reparam_kl takes two (N, C, H, W) tensors of one shape, got "
                         f"{tuple(mu.shape)} and {tuple(lv.shape)}")
    if mu.dtype not in _DTYPE_CODE or lv.dtype != mu.dtype or lv.device != mu.device:
        raise TypeError(f"reparam_kl takes float32 or bfloat16 mu and log_var of one dtype "
                        f"and device, got {mu.dtype}/{lv.dtype} on {mu.device}/{lv.device}")
    if not 0 <= seed < 2 ** 64:
        raise ValueError(f"seed must be in [0, 2**64), got {seed}")
    return _check_map(mu.numel(), base, stripe, 2)


def reparam_kl_reference(mu, lv, seed: int, base: int = 0, stripe=None):
    """Plain PyTorch version of the forward kernel: ``(z, kl)`` with the same
    Philox noise and the same per-element arithmetic."""
    _check_reparam(mu, lv, seed, base, stripe)
    eps = reparam_noise(mu.shape, seed, mu.device, base, stripe)
    m, l = mu.float(), lv.float()
    z = _channels_last((m + torch.exp(0.5 * l) * eps).to(mu.dtype))
    kl = -0.5 * torch.sum(((1.0 + l) - m * m) - torch.exp(l))
    return z, kl


def _reparam_launch_shape(n: int, max_clusters: int) -> LaunchShape:
    """The forward kernel's launch for n elements (256 threads of 4 elements a
    block), at most ``max_clusters`` clusters."""
    return LaunchShape(256, 4, _cluster_grid(n, 1024, max_clusters))


def reparam_launch_for(mu: torch.Tensor, striped: bool = False) -> LaunchShape:
    """The forward kernel's launch for the CUDA tensor ``mu``; ``striped``: the
    kernel's instance for a stripe map (L < G)."""
    with torch.cuda.device(mu.device):
        fits = _max_clusters("reparam_kl", "vaegan_reparam_kl_fwd_max_clusters",
                             mu.device.index, _DTYPE_CODE[mu.dtype], int(striped), CLUSTER)
    return _reparam_launch_shape(mu.numel(), fits)


def reparam_kl_forward(mu, lv, seed: int, base: int = 0, stripe=None):
    """``(z, kl)``: z = mu + exp(lv / 2) * eps with eps ~ N(0, 1) drawn in the
    kernel from seed and each element's global flat NHWC index under the index
    map ``(base, stripe)``, and the KL summed over batch and dims (an f32
    scalar) in the same launch. ``mu``/``lv``: (N, C, H, W) float32/bfloat16,
    made channels_last."""
    mu, lv = _channels_last(mu), _channels_last(lv)
    if _device_kind(mu, "reparam_kl") == "cpu":
        with _plain_cost("reparam_kl", mu):
            return reparam_kl_reference(mu, lv, seed, base, stripe)
    big_l, big_g = _check_reparam(mu, lv, seed, base, stripe)
    shape = reparam_launch_for(mu, big_l != big_g)
    with torch.cuda.device(mu.device):
        z = torch.empty_like(mu, memory_format=torch.channels_last)
        rows = _reduction_scratch(shape, 1, mu.device)
        kl = torch.empty((), dtype=torch.float32, device=mu.device)
        stream = _stream(mu.device)
        fn = _kernel_fn("reparam_kl", "vaegan_reparam_kl_fwd", (_P,) * 6 + (
            _LC, ctypes.c_int, ctypes.c_ulonglong, _LC, _LC, _LC, ctypes.c_int, ctypes.c_int,
            _P))
        rc = fn(mu.data_ptr(), lv.data_ptr(), z.data_ptr(), rows.data_ptr(),
                _ticket(mu.device, stream).data_ptr(), kl.data_ptr(), mu.numel(),
                _DTYPE_CODE[mu.dtype], seed, base, big_l, big_g, shape.blocks, CLUSTER, stream)
    _raise_on(rc, "reparam_kl")
    LAUNCHES["reparam_kl"] += 1
    _launched_cost("reparam_kl", mu)
    return z, kl


def reparam_kl_backward_reference(mu, lv, gz, gkl, seed: int, base: int = 0, stripe=None):
    """Plain PyTorch version of the backward kernel: ``(dmu, dlv)`` with the
    forward's noise replayed; ``gkl`` None counts as 0."""
    _check_reparam(mu, lv, seed, base, stripe)
    eps = reparam_noise(mu.shape, seed, mu.device, base, stripe)
    m, l, g = mu.float(), lv.float(), gz.float()
    k = torch.zeros((), device=mu.device) if gkl is None else gkl.float()
    dmu = g + k * m
    dlv = ((g * 0.5) * torch.exp(0.5 * l)) * eps + (k * -0.5) * (1.0 - torch.exp(l))
    return _channels_last(dmu.to(mu.dtype)), _channels_last(dlv.to(lv.dtype))


def _reparam_bwd_grid(n: int, max_blocks: int) -> int:
    """The backward kernel's blocks for n elements (256 threads of 8 elements a
    pass): no more than the elements need, at most ``max_blocks``."""
    return max(1, min(-(-n // 2048), max_blocks))


def reparam_bwd_blocks(mu: torch.Tensor) -> int:
    """The backward kernel's grid for the CUDA tensor ``mu``: 16 blocks an SM,
    fewer where the elements need fewer. More blocks than fit at once, each of
    a few passes, end more evenly than one resident wave, whose last pass
    leaves most of the card idle (measured on an H100, PERF.md)."""
    return _reparam_bwd_grid(mu.numel(), 16 * _sms(mu.device))


def _reparam_bwd_wave(mu: torch.Tensor, striped: bool = False, kl: bool = False) -> int:
    """One resident wave of the backward kernel's instance (``striped``: for
    L < G; ``kl``: with a KL cotangent) for the CUDA tensor ``mu``: the blocks
    that fit on the card at once, fewer where the elements need fewer."""
    with torch.cuda.device(mu.device):
        per_sm = _max_clusters("reparam_kl", "vaegan_reparam_kl_bwd_blocks_per_sm",
                               mu.device.index, _DTYPE_CODE[mu.dtype], int(striped), int(kl))
    return _reparam_bwd_grid(mu.numel(), per_sm * _sms(mu.device))


def _launch_reparam_bwd(mu, lv, gz, gkl, seed: int, base: int, big_l: int, big_g: int,
                        blocks: int):
    """One launch of the backward kernel on ``blocks`` blocks (checked inputs on
    the card, channels_last); counts nothing."""
    dmu = torch.empty_like(mu, memory_format=torch.channels_last)
    dlv = torch.empty_like(lv, memory_format=torch.channels_last)
    fn = _kernel_fn("reparam_kl", "vaegan_reparam_kl_bwd", (_P,) * 6 + (
        _LC, ctypes.c_int, ctypes.c_ulonglong, _LC, _LC, _LC, ctypes.c_int, _P))
    with torch.cuda.device(mu.device):
        rc = fn(mu.data_ptr(), lv.data_ptr(), gz.data_ptr(),
                None if gkl is None else gkl.data_ptr(), dmu.data_ptr(), dlv.data_ptr(),
                mu.numel(), _DTYPE_CODE[mu.dtype], seed, base, big_l, big_g, blocks,
                _stream(mu.device))
    _raise_on(rc, "reparam_kl backward")
    return dmu, dlv


def reparam_kl_backward(mu, lv, gz, gkl: Optional[torch.Tensor], seed: int, base: int = 0,
                        stripe=None):
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
        with _plain_cost("reparam_kl_bwd", mu):
            return reparam_kl_backward_reference(mu, lv, gz, gkl, seed, base, stripe)
    big_l, big_g = _check_reparam(mu, lv, seed, base, stripe)
    dmu, dlv = _launch_reparam_bwd(mu, lv, gz, gkl, seed, base, big_l, big_g,
                                   reparam_bwd_blocks(mu))
    LAUNCHES["reparam_kl_bwd"] += 1
    _launched_cost("reparam_kl_bwd", mu)
    return dmu, dlv


class _ReparamKL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mu, lv, seed, base, stripe):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(mu, lv)
        ctx.args = (seed, base, stripe)
        return reparam_kl_forward(mu, lv, seed, base, stripe)

    @staticmethod
    @once_differentiable
    def backward(ctx, gz, gkl):
        mu, lv = ctx.saved_tensors
        if gz is None:
            gz = torch.zeros_like(mu)
        dmu, dlv = reparam_kl_backward(mu, lv, gz, gkl, *ctx.args)
        return dmu, dlv, None, None, None


def reparam_kl(mu, log_var, seed: int, base: int = 0, stripe=None):
    """Differentiable :func:`reparam_kl_forward`: ``(z, kl)``."""
    return _ReparamKL.apply(mu, log_var, seed, base, stripe)


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
        with _plain_cost("recon_loss_sums", r):
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
    _launched_cost("recon_loss_sums", r)
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
    count for the mean-reduced L1 + MSE of the reference. Inputs of two dtypes
    (a bfloat16 step's reconstruction against its float32 batch) are both taken
    in float32, exactly, as the TPU kernel casts each; the reconstruction's
    gradient is rounded back to its dtype."""
    if recon.dtype != target.dtype:
        recon, target = recon.float(), target.float()
    return _ReconLossSums.apply(recon, target)


# ---------------------------------------------------------------------------
# cost of a kernel call
# ---------------------------------------------------------------------------

# One Philox4x32-10 call (four 32-bit words): 10 rounds of two 32x32 -> 64-bit
# products (hi and lo: 4), four xors and the two key additions.
_PHILOX_OPS = 100

# Operations per element of each kernel's algorithm, float and integer alike, a
# transcendental (rsqrt, exp, log, sqrt, cos) counted as one: (float32 inputs,
# added for dropout, added for bfloat16 inputs' conversions).
# - bn_act_dropout: x - mean, * (inv scale), + bias; leaky ReLU (compare, *,
#   select); dropout: a quarter Philox call, the keep rule (shift, convert,
#   compare), * 1/(1-p) and select;
# - bn_act_dropout_bwd: the forward's a (3) and xhat (1) again, the mask's
#   replay (as above), leaky' (3), dx (1), the two channel sums (3);
# - reparam_kl: half a Philox call, Box-Muller (two shifts, two converts,
#   + 1, two scalings, log, * -2, sqrt, * 2 pi, cos, *: 13),
#   z = mu + exp(lv/2) eps (4), the KL term and its sum (6);
# - reparam_kl_bwd: the noise again (63), dmu (2), dlv (9);
# - recon_loss_sums: r - t, |d|, +, d^2, +.
_OPS_PER_ELEMENT = {
    "bn_act_dropout": (6, _PHILOX_OPS // 4 + 5, 2),
    "bn_act_dropout_bwd": (11, _PHILOX_OPS // 4 + 5, 3),
    "reparam_kl": (_PHILOX_OPS // 2 + 23, 0, 3),
    "reparam_kl_bwd": (_PHILOX_OPS // 2 + 24, 0, 5),
    "recon_loss_sums": (5, 0, 2),
}


def ops_per_element(name: str, elem_bytes: int = 4, dropout: bool = False) -> int:
    """Operations per element of kernel ``name`` (a key of ``LAUNCHES``)."""
    base, drop, convert = _OPS_PER_ELEMENT[name]
    return base + (drop if dropout else 0) + (convert if elem_bytes == 2 else 0)


def kernel_cost(name: str, numel: int, channels: int = 0, elem_bytes: int = 4,
                dropout: bool = False) -> Tuple[int, int]:
    """``(bytes, operations)`` of one call of kernel ``name`` over ``numel``
    elements of ``elem_bytes`` bytes (``channels``: C of a ``bn_act_dropout``
    call): each input read once and each output written once (the float32
    per-channel vectors and scalars included), and :func:`ops_per_element`
    times the elements."""
    per = {"bn_act_dropout": (2, 16 * channels), "bn_act_dropout_bwd": (3, 32 * channels),
           "reparam_kl": (3, 4), "reparam_kl_bwd": (5, 4), "recon_loss_sums": (2, 8)}[name]
    return (per[0] * numel * elem_bytes + per[1],
            ops_per_element(name, elem_bytes, dropout) * numel)


def _call_cost(name: str, x: torch.Tensor, p: float = 0.0) -> Tuple[int, int]:
    """:func:`kernel_cost` of a call of kernel ``name`` on ``x`` (x, mu or r) at
    dropout ``p``."""
    bn = name.startswith("bn_act_dropout")
    return kernel_cost(name, x.numel(), x.shape[1] if bn else 0, x.element_size(),
                       bn and p > 0.0)


@contextlib.contextmanager
def counting(count):
    """For the duration, tell ``count`` of every kernel call: ``count.add(kernel
    name, bytes, operations)`` (:func:`kernel_cost`) where a wrapper launches,
    and on a CPU tensor around the plain version, whose ops run inside
    ``count.paused()``. One count runs at a time."""
    global _COST
    if _COST is not None:
        raise RuntimeError("a cost count is already running")
    _COST = count
    try:
        yield
    finally:
        _COST = None
