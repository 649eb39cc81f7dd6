"""Encoder / Decoder / code processor / generator (port of
``vaegan_tpu/models/networks.py``; the critic waits for its slice).

Module names follow the JAX package and the reference notebook
(``encoder-depth_1-downsample``, ...), and the block stacks sit one module
deeper, as in the notebook (``encoder.encoder.<block>``, ``decoder.decoder.<block>``),
so the generator's ``state_dict`` is the notebook's: ``vaegan-tpu export`` output
loads with ``strict=True``.

The public methods of :class:`UnsupervisedGeneratorNetwork` take and return the
JAX layout, images (B, H, W, C) and latents (B, h, w, C); inside, the NCHW views
of those buffers are channels_last tensors, so the layout change copies nothing.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import torch
from torch import nn

from vaegan_tpu_torch.config import GeneratorConfig
from vaegan_tpu_torch.models.blocks import ResBlockVAE
from vaegan_tpu_torch.models.layers import Conv2D


def to_nchw(t: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, H, W) view; channels_last when ``t`` is contiguous."""
    return t.permute(0, 3, 1, 2)


def to_nhwc(t: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H, W, C) view; contiguous when ``t`` is channels_last."""
    return t.permute(0, 2, 3, 1)


def _run(blocks: nn.Sequential, x, train, generator):
    for blk in blocks:
        x = blk(x, train=train, generator=generator)
    return x


class Encoder(nn.Module):
    """``length`` level blocks at depth 0, then per depth one downsample block
    doubling the channels plus ``length - 1`` level blocks."""

    def __init__(self, in_channels: int, depth: int, length: int, feature_size: int,
                 **block_kw):
        super().__init__()
        blocks = OrderedDict()
        c = in_channels
        for i in range(length):
            blocks[f"encoder-depth_0-level_{i}"] = ResBlockVAE(c, feature_size, "level", **block_kw)
            c = feature_size
        for d in range(1, depth + 1):
            feature_size *= 2
            blocks[f"encoder-depth_{d}-downsample"] = ResBlockVAE(
                c, feature_size, "downsample", **block_kw)
            c = feature_size
            for item in range(length - 1):
                blocks[f"encoder-depth_{d}-level_{item}"] = ResBlockVAE(
                    c, c, "level", **block_kw)
        self.encoder = nn.Sequential(blocks)

    def forward(self, x, *, train: bool, generator=None):
        return _run(self.encoder, x, train, generator)


class Decoder(nn.Module):
    """Mirror of the encoder: upsample blocks halving the channels, then a final
    level block to ``reconstruction_channels``. No output activation."""

    def __init__(self, in_channels: int, depth: int, length: int,
                 reconstruction_channels: int = 1, **block_kw):
        super().__init__()
        blocks = OrderedDict()
        c = in_channels
        feature_size = in_channels // 2
        for d in range(depth, 0, -1):
            blocks[f"decoder-depth_{d}-upsample"] = ResBlockVAE(
                c, feature_size, "upsample", **block_kw)
            c = feature_size
            for item in range(length - 1):
                blocks[f"decoder-depth_{d}-level_{item}"] = ResBlockVAE(
                    c, c, "level", **block_kw)
            feature_size //= 2
        blocks["decoder-depth_0-reconstruction"] = ResBlockVAE(
            c, reconstruction_channels, "level", **block_kw)
        self.decoder = nn.Sequential(blocks)

    def forward(self, x, *, train: bool, generator=None):
        return _run(self.decoder, x, train, generator)


class SpatialVAECodeProcessor(nn.Module):
    """Fully-convolutional mu / log_var heads; log-var clamped to ±logvar_bound.
    Eval: z = mu. Train: z = mu + exp(log_var / 2) * eps with an injected ``eps``
    (the in-kernel noise of ``reparam_kl`` comes with the training slice)."""

    def __init__(self, feature_depth: int, logvar_bound: float = 50.0,
                 init_scheme: str = "reference", dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.logvar_bound = logvar_bound
        kw = dict(use_bias=True, init_scheme=init_scheme, dtype=dtype, generator=generator)
        self.mu = Conv2D(feature_depth, feature_depth, 3, 1, 1, **kw)
        self.log_var = Conv2D(feature_depth, feature_depth, 3, 1, 1, **kw)

    def forward(self, x, *, train: bool, eps: Optional[torch.Tensor] = None):
        log_var = torch.clamp(self.log_var(x), -self.logvar_bound, self.logvar_bound)
        mu = self.mu(x)
        if not train:
            return mu, mu, log_var
        if eps is None:
            raise ValueError("train-mode reparameterization needs an injected eps "
                             "until the in-kernel noise (reparam_kl) is ported")
        z = mu + torch.exp(0.5 * log_var) * eps.to(mu.dtype)
        return z, mu, log_var


class UnsupervisedGeneratorNetwork(nn.Module):
    """encoder -> code processor -> decoder, on (B, H, W, C) images."""

    def __init__(self, cfg: GeneratorConfig, init_scheme: str = "reference",
                 dtype: torch.dtype = torch.float32, use_pallas: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        kw = dict(res_mode=cfg.res_mode, dropout_prob=cfg.dropout_prob,
                  init_scheme=init_scheme, dtype=dtype, use_pallas=use_pallas,
                  generator=generator)
        self.encoder = Encoder(cfg.in_channels, cfg.depth, cfg.length, cfg.feature_size, **kw)
        # non-VAE: the encoder features are the code and no code head exists,
        # as in the JAX package
        self.code_processor = SpatialVAECodeProcessor(
            cfg.feature_depth, cfg.logvar_bound, init_scheme=init_scheme, dtype=dtype,
            generator=generator) if cfg.is_vae else None
        self.decoder = Decoder(cfg.feature_depth, cfg.depth, cfg.length,
                               reconstruction_channels=cfg.in_channels, **kw)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """VAE: ``(recon, mu, log_var)``; non-VAE: ``recon``. ``eps`` (train mode)
        is (B, h, w, C) noise; ``generator`` draws the dropout masks in train mode."""
        h = self.encoder(to_nchw(x.contiguous()), train=train, generator=generator)
        if not self.cfg.is_vae:
            return to_nhwc(self.decoder(h, train=train, generator=generator))
        z, mu, log_var = self.code_processor(
            h, train=train, eps=None if eps is None else to_nchw(eps))
        recon = self.decoder(z, train=train, generator=generator)
        return to_nhwc(recon), to_nhwc(mu), to_nhwc(log_var)

    def encode(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        h = self.encoder(to_nchw(x.contiguous()), train=train)
        return to_nhwc(h if self.code_processor is None else self.code_processor.mu(h))

    def decode(self, z: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        return to_nhwc(self.decoder(to_nchw(z.contiguous()), train=train))
