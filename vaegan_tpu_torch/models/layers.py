"""Layers with torch-exact semantics (port of ``vaegan_tpu/models/layers.py``).

Inside the models activations are (N, C, H, W) tensors in ``torch.channels_last``
memory format: the NHWC buffer the JAX package used, with cuDNN keeping that
format through every convolution, so the fused kernel sees each BatchNorm input
as the row-major (N*H*W, C) matrix the TPU kernel saw.

Every ``forward`` takes ``train`` explicitly, as the JAX modules do; the
``nn.Module.training`` flag is not read. Parameter and buffer names follow torch's
``nn.Conv2d`` / ``nn.BatchNorm2d`` so a generator ``state_dict`` has the
reference notebook's key layout. Spectral norm waits for the critic.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vaegan_tpu_torch.ops.fused import bn_act_dropout
from vaegan_tpu_torch.ops.initializers import conv_init
from vaegan_tpu_torch.ops.norm import batch_norm


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
def ieee_float32_convs():
    """cuDNN convolutions in IEEE float32 for the duration, whatever the
    process-wide default (PyTorch's is TF32, 10 mantissa bits); restored after."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


class Conv2D(nn.Module):
    """``nn.Conv2d`` / ``nn.ConvTranspose2d`` (bias optional) whose weight is cast
    to the compute ``dtype`` at call time; parameters stay float32.

    A float32 layer convolves in IEEE float32 on the card, as the config says and
    as the JAX package's tests run it, not in the TF32 that PyTorch's cuDNN
    default would pick; faster convolutions are the ``bfloat16`` config's."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, *, use_bias: bool = False,
                 transpose: bool = False, init_scheme: str = "reference",
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.transpose, self.dtype = transpose, dtype
        shape = ((in_channels, out_channels) if transpose else
                 (out_channels, in_channels)) + (kernel_size, kernel_size)
        self.weight = nn.Parameter(torch.empty(shape))
        conv_init(init_scheme, transpose=transpose)(self.weight, generator)
        self.bias = nn.Parameter(torch.zeros(out_channels)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        conv = F.conv_transpose2d if self.transpose else F.conv2d
        x = as_channels_last(x.to(self.dtype))
        if self.dtype != torch.float32:
            return conv(x, w, b, stride=self.stride, padding=self.padding)
        with ieee_float32_convs():
            return conv(x, w, b, stride=self.stride, padding=self.padding)


class BatchNorm(nn.Module):
    """torch-exact BatchNorm2d (see ``ops.norm``).

    ``fuse=(slope, p)`` runs normalize + LeakyReLU(slope) + dropout(p) as the one
    fused pass of ``ops.fused.bn_act_dropout``. In eval mode it is fed the running
    statistics and runs at p = 0, as the JAX module does. The fused path has no
    backward yet, so in train mode it raises (the training slice brings the
    backward kernel); the unfused path trains.
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

    def forward(self, x: torch.Tensor, *, train: bool,
                fuse: Optional[Tuple[float, float]] = None) -> torch.Tensor:
        if fuse is None:
            y, new_mean, new_var = batch_norm(
                x.to(self.dtype), self.weight, self.bias, self.running_mean,
                self.running_var, use_running_average=not train,
                momentum=self.momentum, eps=self.eps)
        else:
            if train:
                raise NotImplementedError(
                    "the fused BN+LeakyReLU+dropout path is forward-only until its "
                    "backward kernel is ported; train with use_pallas='off'")
            slope, _ = fuse
            y = bn_act_dropout(x.to(self.dtype), self.running_mean, self.running_var,
                               self.weight, self.bias, 0, float(slope), 0.0, float(self.eps))
        if train:
            # the port updates the running statistics in place
            with torch.no_grad():
                self.running_mean.copy_(new_mean)
                self.running_var.copy_(new_var)
        return y


class Dropout(nn.Module):
    """Inverted dropout; ``channelwise=True`` reproduces ``nn.Dropout2d`` (whole
    feature maps dropped). The mask is drawn from the given ``torch.Generator``."""

    def __init__(self, rate: float, channelwise: bool = False):
        super().__init__()
        self.rate, self.channelwise = rate, channelwise

    def forward(self, x: torch.Tensor, *, train: bool,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not train or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0], x.shape[1], 1, 1) if self.channelwise else x.shape
        mask = torch.empty(shape, device=x.device).bernoulli_(keep, generator=generator)
        return torch.where(mask.bool(), x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def leaky_relu(x: torch.Tensor, negative_slope: float) -> torch.Tensor:
    # strict ``x > 0``, torch's subgradient convention at 0 (layers.py:181-187)
    return torch.where(x > 0, x, x * negative_slope)
