"""Layers with torch-exact semantics (port of ``vaegan_tpu/models/layers.py``).

Inside the models activations are (N, C, H, W) tensors in ``torch.channels_last``
memory format: the NHWC buffer the JAX package used, with cuDNN keeping that
format through every convolution, so the fused kernel sees each BatchNorm input
as the row-major (N*H*W, C) matrix the TPU kernel saw.

Every ``forward`` takes ``train`` explicitly, as the JAX modules do; the
``nn.Module.training`` flag is not read. Parameter and buffer names follow torch's
``nn.Conv2d`` / ``nn.BatchNorm2d`` / ``nn.Linear`` and ``nn.utils.spectral_norm``
(``weight_orig``, ``weight_u``, ``weight_v``), so the generator's and the critic's
``state_dict`` have the reference notebook's key layout.

Random draws: a fused BatchNorm's dropout seed is a 64-bit int drawn from a CPU
``torch.Generator`` (``seeds``), so drawing it never waits on the device; the
unfused dropout masks are drawn on the activation's device (``generator``).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vaegan_tpu_torch.ops.fused import bn_act_dropout
from vaegan_tpu_torch.ops.initializers import conv_init, kaiming_normal_
from vaegan_tpu_torch.ops.norm import batch_norm, batch_stats
from vaegan_tpu_torch.ops.spectral_norm import l2_normalize, spectral_normalize


def as_channels_last(x: torch.Tensor) -> torch.Tensor:
    """``x`` with canonical channels_last strides. A tensor with one channel is
    channels_last-contiguous and NCHW-contiguous at once, and then the strides
    elementwise ops happened to give it decide which format the next convolution
    picks; this view settles it to channels_last without a copy."""
    if x.is_contiguous(memory_format=torch.channels_last):
        n, c, h, w = x.shape
        return x.as_strided(x.shape, (h * w * c, 1, w * c, c))
    return x.contiguous(memory_format=torch.channels_last)


@contextlib.contextmanager
def ieee_float32():
    """cuDNN convolutions and cuBLAS matmuls in IEEE float32 for the duration,
    whatever the process-wide defaults (PyTorch's convolutions default to TF32,
    10 mantissa bits); restored after. Autograd runs a backward later, outside a
    forward's context, so a float32 train step holds this around its backward
    and double-backward calls too (``train.step``)."""
    prev = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = prev


def precision(dtype: torch.dtype):
    """:func:`ieee_float32` for a float32 model, nothing for a bfloat16 one."""
    return ieee_float32() if dtype == torch.float32 else contextlib.nullcontext()


def draw_seed(seeds: Optional[torch.Generator]) -> int:
    """A kernel seed in [0, 2**63) from a CPU generator (the global one if None)."""
    return int(torch.randint(0, 2 ** 63 - 1, (), generator=seeds))


class Conv2D(nn.Module):
    """``nn.Conv2d`` / ``nn.ConvTranspose2d`` (bias optional), optionally wrapped
    in ``nn.utils.spectral_norm`` (``spectral=True``: parameter ``weight_orig``,
    buffers ``weight_u``/``weight_v``, one power iteration per train forward).
    The weight is cast to the compute ``dtype`` at call time; parameters stay
    float32.

    A float32 layer convolves in IEEE float32 on the card, as the config says and
    as the JAX package's tests run it, not in the TF32 that PyTorch's cuDNN
    default would pick; faster convolutions are the ``bfloat16`` config's."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, *, use_bias: bool = False,
                 transpose: bool = False, spectral: bool = False,
                 init_scheme: str = "reference", dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if spectral and transpose:
            raise ValueError("spectral norm of a transposed conv is not used by the models")
        self.stride, self.padding = stride, padding
        self.transpose, self.spectral, self.dtype = transpose, spectral, dtype
        shape = ((in_channels, out_channels) if transpose else
                 (out_channels, in_channels)) + (kernel_size, kernel_size)
        w = nn.Parameter(torch.empty(shape))
        conv_init(init_scheme, transpose=transpose, spectral=spectral)(w, generator)
        if spectral:
            self.weight_orig = w
            # torch's wrap-time init: normalized N(0, 1) vectors
            for name, dim in (("weight_u", shape[0]), ("weight_v", w[0].numel())):
                self.register_buffer(
                    name, l2_normalize(torch.randn(dim, generator=generator)))
        else:
            self.weight = w
        self.bias = nn.Parameter(torch.zeros(out_channels)) if use_bias else None

    def effective_weight(self, train: bool) -> torch.Tensor:
        """The weight the convolution uses: W / sigma for a spectral layer (whose
        train-mode call advances ``weight_u``/``weight_v`` in place), else W."""
        if not self.spectral:
            return self.weight
        w, u, v = spectral_normalize(self.weight_orig, self.weight_u, self.weight_v,
                                     update=train)
        if train:
            with torch.no_grad():
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
        return w

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        w = self.effective_weight(train).to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        conv = F.conv_transpose2d if self.transpose else F.conv2d
        stride = self.stride
        if w.shape[-1] == 1 and self.padding == 0 and not self.transpose and stride > 1:
            # a strided 1x1 conv reads every stride-th pixel: subsample, then a
            # stride-1 conv (the same numbers; PyTorch's CPU double backward of a
            # strided 1x1 channels_last conv corrupts memory)
            x, stride = x[:, :, ::stride, ::stride], 1
        x = as_channels_last(x.to(self.dtype))
        with precision(self.dtype):
            return conv(x, w, b, stride=stride, padding=self.padding)


class Linear(nn.Module):
    """``nn.Linear`` with the reference's kaiming-normal weight and zero bias;
    the weight is cast to the compute ``dtype`` at call time."""

    def __init__(self, in_features: int, out_features: int, *,
                 init_scheme: str = "reference", dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if init_scheme not in ("clean", "reference"):
            raise ValueError(f"unknown init scheme {init_scheme!r}")
        self.dtype = dtype
        self.weight = nn.Parameter(kaiming_normal_(torch.empty(out_features, in_features),
                                                   generator))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with precision(self.dtype):
            return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                            self.bias.to(self.dtype))


class BatchNorm(nn.Module):
    """torch-exact BatchNorm2d (see ``ops.norm``).

    ``fuse=(slope, p)`` runs normalize + LeakyReLU(slope) + dropout(p) as the one
    fused pass of ``ops.fused.bn_act_dropout``, as the JAX module does: train mode
    feeds it the batch statistics (computed by differentiable torch ops, so the
    kernel's backward continues into them) and a dropout seed drawn from
    ``seeds``; eval mode feeds it the running statistics at p = 0. The last
    call's ``(seed, input shape)`` is kept as ``last_draw``, so the mask can be
    replayed (``fused.keep_mask``) to hold the fused path against the unfused one.
    """

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        # kept for torch's key layout; the JAX package tracks no BN step count
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

        self.last_draw: Optional[Tuple[int, Tuple[int, ...]]] = None

    def forward(self, x: torch.Tensor, *, train: bool,
                fuse: Optional[Tuple[float, float]] = None,
                seeds: Optional[torch.Generator] = None) -> torch.Tensor:
        if fuse is None:
            y, new_mean, new_var = batch_norm(
                x.to(self.dtype), self.weight, self.bias, self.running_mean,
                self.running_var, use_running_average=not train,
                momentum=self.momentum, eps=self.eps)
        else:
            slope, p = fuse
            m, v, new_mean, new_var = batch_stats(
                x, self.running_mean, self.running_var, use_running_average=not train,
                momentum=self.momentum)
            p = float(p) if train else 0.0
            seed = draw_seed(seeds) if p > 0.0 else 0
            self.last_draw = (seed, tuple(x.shape))
            y = bn_act_dropout(x.to(self.dtype), m, v, self.weight, self.bias, seed,
                               float(slope), p, float(self.eps))
        if train:
            # the port updates the running statistics in place
            with torch.no_grad():
                self.running_mean.copy_(new_mean)
                self.running_var.copy_(new_var)
        return y


class Dropout(nn.Module):
    """Inverted dropout; ``channelwise=True`` reproduces ``nn.Dropout2d`` (whole
    feature maps dropped). The mask is drawn from the given ``torch.Generator``,
    unless a keep-mask is injected: ``mask`` (NCHW, broadcastable to the input;
    set by ``inject_masks``) overrides the draw, read-only, as the JAX module's
    ``masks`` collection does for the parity harness."""

    def __init__(self, rate: float, channelwise: bool = False):
        super().__init__()
        self.rate, self.channelwise = rate, channelwise
        self.mask: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor, *, train: bool,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not train or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        if self.mask is not None:
            mask = self.mask.to(x.device)
        else:
            shape = (x.shape[0], x.shape[1], 1, 1) if self.channelwise else x.shape
            mask = torch.empty(shape, device=x.device).bernoulli_(keep, generator=generator)
        return torch.where(mask.bool(), x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


@contextlib.contextmanager
def inject_masks(module: nn.Module, masks: Optional[Dict[str, torch.Tensor]]):
    """Give the :class:`Dropout` modules of ``module`` the keep-masks of
    ``masks`` (``{module path: NCHW mask}``, the reference notebook's paths) for
    the duration; an unknown path raises."""
    if not masks:
        yield
        return
    sites = {name: m for name, m in module.named_modules() if isinstance(m, Dropout)}
    unknown = sorted(set(masks) - set(sites))
    if unknown:
        raise KeyError(f"no Dropout module at {unknown[:4]}")
    try:
        for name, mask in masks.items():
            sites[name].mask = mask
        yield
    finally:
        for name in masks:
            sites[name].mask = None


def leaky_relu(x: torch.Tensor, negative_slope: float) -> torch.Tensor:
    # strict ``x > 0``, torch's subgradient convention at 0 (layers.py:181-187)
    return torch.where(x > 0, x, x * negative_slope)
