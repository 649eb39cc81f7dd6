"""Residual blocks (port of ``vaegan_tpu/models/blocks.py``).

``ResBlockVAE``: pre-activation (default) order is BN -> LeakyReLU(0.01) ->
Dropout -> conv1 -> BN -> LeakyReLU -> conv2, plus an *always-conv* shortcut
(conv + BN even in "level" mode). Elementwise dropout p=0.5; all convs bias-free.
With ``use_pallas`` each BN -> LeakyReLU (-> Dropout) chain is one fused kernel
launch. The shortcut is ``shortcut.0`` (conv) / ``shortcut.1`` (BN), the
reference notebook's ``Sequential`` key layout.

``ResBlockDiscriminator``: the critic's block. Both convs and the 1x1 projection
shortcut are spectral-normalized; channel dropout (``nn.Dropout2d``) after conv1;
LeakyReLU slope 0.2; the shortcut is the identity unless the stride or the
channel count changes. With ``use_pallas`` its BN -> LeakyReLU chains are fused
at p = 0; the critic is built fused only when no gradient penalty is configured,
since the kernel's backward is not twice-differentiable (``train.state``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vaegan_tpu_torch.models.layers import BatchNorm, Conv2D, Dropout, leaky_relu


class ResBlockVAE(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, mode: str = "level",
                 res_mode: str = "pre-activation", dropout_prob: float = 0.5,
                 negative_slope: float = 0.01, init_scheme: str = "reference",
                 dtype: torch.dtype = torch.float32, use_pallas: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if res_mode not in ("pre-activation", "standard"):
            raise ValueError(f"unknown res_mode {res_mode!r}")
        kw = dict(init_scheme=init_scheme, dtype=dtype, generator=generator)
        if mode == "level":
            conv = dict(kernel_size=3, stride=1, padding=1)
        elif mode == "upsample":
            conv = dict(kernel_size=4, stride=2, padding=1, transpose=True)
        elif mode == "downsample":
            conv = dict(kernel_size=3, stride=2, padding=1)
        else:
            raise ValueError(f"unknown mode {mode!r}")
        self.res_mode, self.use_pallas = res_mode, use_pallas
        self.slope, self.p = negative_slope, dropout_prob
        bn1_ch = in_channels if res_mode == "pre-activation" else out_channels
        self.bn1 = BatchNorm(bn1_ch, dtype=dtype)
        self.conv1 = Conv2D(in_channels, out_channels, **conv, **kw)
        self.bn2 = BatchNorm(out_channels, dtype=dtype)
        self.conv2 = Conv2D(out_channels, out_channels, 3, 1, 1, **kw)
        self.shortcut = nn.Sequential(Conv2D(in_channels, out_channels, **conv, **kw),
                                      BatchNorm(out_channels, dtype=dtype))
        self.dropout = Dropout(dropout_prob)

    def forward(self, x: torch.Tensor, *, train: bool,
                generator: Optional[torch.Generator] = None,
                seeds: Optional[torch.Generator] = None) -> torch.Tensor:
        act = lambda t: leaky_relu(t, self.slope)  # noqa: E731
        drop = lambda t: self.dropout(t, train=train, generator=generator)  # noqa: E731
        shortcut = self.shortcut[1](self.shortcut[0](x), train=train)
        if self.res_mode == "standard":
            out = self.conv1(x)
            if self.use_pallas:  # BN -> act -> dropout, one fused pass
                out = self.bn1(out, train=train, fuse=(self.slope, self.p), seeds=seeds)
            else:
                out = drop(act(self.bn1(out, train=train)))
            out = self.conv2(out)
            out = self.bn2(out, train=train)
            return act(out + shortcut)
        if self.use_pallas:
            out = self.bn1(x, train=train, fuse=(self.slope, self.p), seeds=seeds)
            out = self.conv1(out)
            out = self.bn2(out, train=train, fuse=(self.slope, 0.0))
        else:
            out = drop(act(self.bn1(x, train=train)))
            out = self.conv1(out)
            out = act(self.bn2(out, train=train))
        out = self.conv2(out)
        return out + shortcut


class ResBlockDiscriminator(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, res_stride: int = 1,
                 res_mode: str = "pre-activation", dropout_prob: float = 0.5,
                 negative_slope: float = 0.2, init_scheme: str = "reference",
                 dtype: torch.dtype = torch.float32, use_pallas: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if res_mode not in ("pre-activation", "standard"):
            raise ValueError(f"unknown res_mode {res_mode!r}")
        kw = dict(spectral=True, init_scheme=init_scheme, dtype=dtype, generator=generator)
        self.res_mode, self.use_pallas, self.slope = res_mode, use_pallas, negative_slope
        self.conv1 = Conv2D(in_channels, out_channels, 3, res_stride, 1, **kw)
        self.conv2 = Conv2D(out_channels, out_channels, 3, 1, 1, **kw)
        bn1_ch = in_channels if res_mode == "pre-activation" else out_channels
        self.bn1 = BatchNorm(bn1_ch, dtype=dtype)
        self.bn2 = BatchNorm(out_channels, dtype=dtype)
        self.dropout = Dropout(dropout_prob, channelwise=True)
        # projection shortcut only on a shape change (the notebook's rule)
        self.shortcut = None
        if res_stride != 1 or out_channels != in_channels:
            self.shortcut = nn.Sequential(
                Conv2D(in_channels, out_channels, 1, res_stride, 0, **kw),
                BatchNorm(out_channels, dtype=dtype))

    def _bn_act(self, bn: BatchNorm, x: torch.Tensor, train: bool) -> torch.Tensor:
        if self.use_pallas:
            return bn(x, train=train, fuse=(self.slope, 0.0))
        return leaky_relu(bn(x, train=train), self.slope)

    def forward(self, x: torch.Tensor, *, train: bool,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if self.shortcut is not None:
            shortcut = self.shortcut[1](self.shortcut[0](x, train=train), train=train)
        else:
            shortcut = x.to(self.conv1.dtype)
        if self.res_mode == "standard":
            out = self.conv1(x, train=train)
            out = self.dropout(out, train=train, generator=generator)
            out = self._bn_act(self.bn1, out, train)
            out = self.conv2(out, train=train)
            out = self.bn2(out, train=train)
            return leaky_relu(out + shortcut, self.slope)
        out = self._bn_act(self.bn1, x, train)
        out = self.conv1(out, train=train)
        out = self.dropout(out, train=train, generator=generator)
        out = self._bn_act(self.bn2, out, train)
        out = self.conv2(out, train=train)
        return out + shortcut
