"""Encoder / Decoder / code processor / generator / critic (port of
``vaegan_tpu/models/networks.py``).

Module names follow the JAX package and the reference notebook
(``encoder-depth_1-downsample``, ...), and the block stacks sit one module
deeper, as in the notebook (``encoder.encoder.<block>``, ``decoder.decoder.<block>``),
so the generator's ``state_dict`` is the notebook's: ``vaegan-tpu export`` output
loads with ``strict=True``.

The public methods of :class:`UnsupervisedGeneratorNetwork` and
:class:`Discriminator` take and return the JAX layout, images (B, H, W, C) and
latents (B, h, w, C); inside, the NCHW views of those buffers are channels_last
tensors, so the layout change copies nothing. The critic flattens its pooled
map in torch's (C, H, W) order, the notebook's (``interop`` permutes the JAX
package's first linear accordingly).

``remat`` (``cfg.train.remat``) runs every residual block of the encoder, the
decoder and the critic under recomputation in a train forward that records a
graph (``layers.remat``), as the JAX package's ``_block_runner`` wraps them in
``nn.remat``. ``replica`` (``ops.replica``) makes a forward part of a
parallel step: global batch statistics, the global step's draws, conv halos
under spatial sharding (each process runs every layer on its stripe of H), and
the critic head's gathers (the pooled stripes before the flatten, the outputs
of a linear whose kernel is split over the model axis).
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vaegan_tpu_torch.config import DiscriminatorConfig, GeneratorConfig
from vaegan_tpu_torch.models.blocks import ResBlockDiscriminator, ResBlockVAE
from vaegan_tpu_torch.models.layers import (
    BatchNorm,
    Conv2D,
    Linear,
    draw_seed,
    leaky_relu,
    remat,
)
from vaegan_tpu_torch.ops.fused import reparam_kl
from vaegan_tpu_torch.ops.replica import LOCAL, Replica
from vaegan_tpu_torch.utils.profiling import count


def to_nchw(t: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, H, W) view; channels_last when ``t`` is contiguous."""
    return t.permute(0, 3, 1, 2)


def to_nhwc(t: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H, W, C) view; contiguous when ``t`` is channels_last."""
    return t.permute(0, 2, 3, 1)


def run_blocks(blocks, x, *, recompute: bool, train: bool, **kw):
    """The blocks in order, each recomputed in the backward when ``recompute``
    and the forward records a graph (a train step's)."""
    recompute = recompute and train and torch.is_grad_enabled()
    for blk in blocks:
        x = remat(blk, x, train=train, **kw) if recompute else blk(x, train=train, **kw)
    return x


class Encoder(nn.Module):
    """``length`` level blocks at depth 0, then per depth one downsample block
    doubling the channels plus ``length - 1`` level blocks."""

    def __init__(self, in_channels: int, depth: int, length: int, feature_size: int,
                 remat: bool = False, **block_kw):
        super().__init__()
        self.remat = remat
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

    def forward(self, x, *, train: bool, generator=None, seeds=None, replica=LOCAL):
        return run_blocks(self.encoder, x, recompute=self.remat, train=train,
                          generator=generator, seeds=seeds, replica=replica)


class Decoder(nn.Module):
    """Mirror of the encoder: upsample blocks halving the channels, then a final
    level block to ``reconstruction_channels``. No output activation."""

    def __init__(self, in_channels: int, depth: int, length: int,
                 reconstruction_channels: int = 1, remat: bool = False, **block_kw):
        super().__init__()
        self.remat = remat
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

    def forward(self, x, *, train: bool, generator=None, seeds=None, replica=LOCAL):
        return run_blocks(self.decoder, x, recompute=self.remat, train=train,
                          generator=generator, seeds=seeds, replica=replica)


class SpatialVAECodeProcessor(nn.Module):
    """Fully-convolutional mu / log_var heads; log-var clamped to ±logvar_bound.
    Eval: z = mu. Train: z = mu + exp(log_var / 2) * eps, with ``eps`` injected,
    else drawn in the ``reparam_kl`` kernel from a seed drawn from ``seeds``
    (``use_pallas``; ``(seed, mu's global shape)`` is kept as ``last_draw`` for a
    replay with ``fused.reparam_noise``), else drawn on the device from
    ``generator``; a parallel process draws its rows (and stripe) of the global
    noise."""

    def __init__(self, feature_depth: int, logvar_bound: float = 50.0,
                 init_scheme: str = "reference", dtype: torch.dtype = torch.float32,
                 use_pallas: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.logvar_bound, self.use_pallas = logvar_bound, use_pallas
        self.last_draw: Optional[Tuple[int, Tuple[int, ...]]] = None
        kw = dict(use_bias=True, init_scheme=init_scheme, dtype=dtype, generator=generator)
        self.mu = Conv2D(feature_depth, feature_depth, 3, 1, 1, **kw)
        self.log_var = Conv2D(feature_depth, feature_depth, 3, 1, 1, **kw)

    def forward(self, x, *, train: bool, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                seeds: Optional[torch.Generator] = None, replica: Replica = LOCAL):
        log_var = torch.clamp(self.log_var(x, replica=replica), -self.logvar_bound,
                              self.logvar_bound)
        mu = self.mu(x, replica=replica)
        if not train:
            return mu, mu, log_var
        if eps is None and self.use_pallas:
            # the fused KL rides along unused: the loss recomputes the KL from
            # (mu, log_var) with the configured reduction, so its cotangent is 0
            seed = draw_seed(seeds)
            self.last_draw = (seed, replica.global_shape(mu.shape, 2))
            base, big_l, big_g = replica.index_map(mu.shape)
            z, _ = reparam_kl(mu, log_var, seed, base, (big_l, big_g))
            return z, mu, log_var
        if eps is None:
            n, c, h, w = mu.shape
            eps = replica.draw((n, h, w, c), lambda s: torch.randn(
                s, generator=generator, device=mu.device, dtype=mu.dtype),
                1).permute(0, 3, 1, 2)
        z = mu + torch.exp(0.5 * log_var) * eps.to(mu.dtype)
        return z, mu, log_var


class UnsupervisedGeneratorNetwork(nn.Module):
    """encoder -> code processor -> decoder, on (B, H, W, C) images."""

    def __init__(self, cfg: GeneratorConfig, init_scheme: str = "reference",
                 dtype: torch.dtype = torch.float32, use_pallas: bool = False,
                 fuse_reparam: bool = False, generator: Optional[torch.Generator] = None,
                 remat: bool = False):
        super().__init__()
        self.cfg = cfg
        kw = dict(res_mode=cfg.res_mode, dropout_prob=cfg.dropout_prob,
                  init_scheme=init_scheme, dtype=dtype, use_pallas=use_pallas,
                  generator=generator, remat=remat)
        self.encoder = Encoder(cfg.in_channels, cfg.depth, cfg.length, cfg.feature_size, **kw)
        # non-VAE: the encoder features are the code and no code head exists,
        # as in the JAX package
        self.code_processor = SpatialVAECodeProcessor(
            cfg.feature_depth, cfg.logvar_bound, init_scheme=init_scheme, dtype=dtype,
            use_pallas=use_pallas or fuse_reparam,
            generator=generator) if cfg.is_vae else None
        self.decoder = Decoder(cfg.feature_depth, cfg.depth, cfg.length,
                               reconstruction_channels=cfg.in_channels, **kw)

    def forward(self, x: torch.Tensor, *, train: bool = False,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                seeds: Optional[torch.Generator] = None, replica: Replica = LOCAL):
        """VAE: ``(recon, mu, log_var)``; non-VAE: ``recon``. In train mode ``eps``
        is optional injected (B, h, w, C) noise, ``generator`` (on the device)
        draws the unfused dropout masks and noise, ``seeds`` (a CPU generator)
        draws the fused kernels' seeds, and ``replica`` places the forward in a
        data-parallel step."""
        kw = dict(train=train, generator=generator, seeds=seeds, replica=replica)
        h = self.encoder(to_nchw(x.contiguous()), **kw)
        if not self.cfg.is_vae:
            return to_nhwc(self.decoder(h, **kw))
        z, mu, log_var = self.code_processor(
            h, eps=None if eps is None else to_nchw(eps), **kw)
        recon = self.decoder(z, **kw)
        return to_nhwc(recon), to_nhwc(mu), to_nhwc(log_var)

    def encode(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        """Images -> the code (mu), one process."""
        h = self.encoder(to_nchw(x.contiguous()), train=train)
        return to_nhwc(h if self.code_processor is None else self.code_processor.mu(h))

    def decode(self, z: torch.Tensor, *, train: bool = False,
               generator: Optional[torch.Generator] = None,
               seeds: Optional[torch.Generator] = None,
               replica: Replica = LOCAL) -> torch.Tensor:
        """Latents (B, h, w, C) -> images. In train mode (the Larsen step's prior
        sample decode) ``generator``, ``seeds`` and ``replica`` are as in
        :meth:`forward`."""
        return to_nhwc(self.decoder(to_nchw(z.contiguous()), train=train, generator=generator,
                                    seeds=seeds, replica=replica))


def check_stripes(cfg, stripes: int) -> None:
    """Raise ``ValueError`` naming the first stage of the generator or the
    critic of ``cfg`` (a ``Config``) whose H the ``stripes`` of spatial
    sharding do not divide, or whose stride does not divide the stripe."""
    def need(stage, h, step=1):
        if h % (stripes * step):
            raise ValueError(f"spatial sharding over {stripes} stripes: {stage} has H {h}, "
                             f"which is not a multiple of {stripes} x {step}")

    g, d, size = cfg.generator, cfg.discriminator, cfg.data.image_size
    h = size
    need("encoder-depth_0", h)
    for i in range(1, g.depth + 1):
        need(f"encoder-depth_{i}-downsample (stride 2)", h, 2)
        h //= 2
    need("the latent", h)
    need("critic conv1" + (f" (stride {d.num_stride_conv1})" if d.num_stride_conv1 > 1 else ""),
         size, d.num_stride_conv1)
    h = size // d.num_stride_conv1
    for i, st in enumerate(d.num_strides_res):
        need(f"critic res_layers.{i} (stride {st})", h, st)
        h //= st
    need(f"critic avg-pool (window {d.pool_size})", h, d.pool_size)


def critic_pool_shape(cfg: DiscriminatorConfig, image_size: int) -> Tuple[int, int, int]:
    """(C, H, W) of the critic's avg-pool output for ``image_size`` inputs (what
    its first linear layer reads, flattened)."""
    s = -(-image_size // cfg.num_stride_conv1)     # pad-1 3x3 stride conv: ceil-div
    for st in cfg.num_strides_res:
        s = -(-s // st)
    s //= cfg.pool_size                             # avg_pool2d floors
    return (cfg.num_features_res[-1], s, s)


class Discriminator(nn.Module):
    """The notebook's critic: conv1 + BN + LeakyReLU(0.2), residual stages of
    :class:`ResBlockDiscriminator`, avg-pool, then linear layers with
    LeakyReLU(0.2) to one logit (no sigmoid: a WGAN critic).

    The first linear layer's width comes from ``image_size`` (the JAX module
    reads it off the traced shape; a PyTorch module sizes its weights when it is
    built). ``return_features`` also returns the ``cfg.feature_tap`` activation
    (``res_out``, ``pool`` or ``fc1``) for the Dis_l feature-matching loss.
    Built fused, the stem's BN + LeakyReLU counts ``critic.fused_bn_act`` as
    each block's chains do."""

    def __init__(self, cfg: DiscriminatorConfig, image_size: int,
                 init_scheme: str = "reference", dtype: torch.dtype = torch.float32,
                 use_pallas: bool = False, generator: Optional[torch.Generator] = None,
                 remat: bool = False):
        super().__init__()
        self.cfg, self.image_size, self.use_pallas = cfg, image_size, use_pallas
        self.remat = remat
        self.conv1 = Conv2D(cfg.in_channels, cfg.num_features_conv1, 3, cfg.num_stride_conv1,
                            1, init_scheme=init_scheme, dtype=dtype, generator=generator)
        self.bn1 = BatchNorm(cfg.num_features_conv1, dtype=dtype)
        stages, c = [], cfg.num_features_conv1
        for planes, blocks, stride in zip(cfg.num_features_res, cfg.num_blocks,
                                          cfg.num_strides_res):
            stage = []
            for b in range(blocks):
                stage.append(ResBlockDiscriminator(
                    c, planes, stride if b == 0 else 1, res_mode=cfg.res_mode,
                    dropout_prob=cfg.dropout_prob, init_scheme=init_scheme, dtype=dtype,
                    use_pallas=use_pallas, generator=generator))
                c = planes
            stages.append(nn.Sequential(*stage))
        self.res_layers = nn.Sequential(*stages)
        self.pool_shape = critic_pool_shape(cfg, image_size)
        width = self.pool_shape[0] * self.pool_shape[1] * self.pool_shape[2]
        for j, out in enumerate(tuple(cfg.linear_widths) + (1,)):
            setattr(self, f"linear_{j + 1}", Linear(width, out, init_scheme=init_scheme,
                                                    dtype=dtype, generator=generator))
            width = out
        self.n_linear = len(cfg.linear_widths) + 1

    def forward(self, x: torch.Tensor, *, train: bool, return_features: bool = False,
                generator: Optional[torch.Generator] = None, replica: Replica = LOCAL):
        """``x`` (B, H, W, C) -> logits (B, 1) [, the tapped features in the JAX
        layout: (B, h, w, C) for ``res_out``/``pool``, (B, F) for ``fc1``].
        Under spatial sharding ``x`` and the map features are this process's
        stripes; the logits and ``fc1`` are whole on every process."""
        if x.shape[1] * replica.split_h != self.image_size or x.shape[2] != self.image_size:
            raise ValueError(f"this critic was built for {self.image_size}x{self.image_size} "
                             f"images, got {tuple(x.shape)}")
        act = lambda t: leaky_relu(t, 0.2)  # noqa: E731
        out = self.conv1(to_nchw(x.contiguous()), replica=replica)
        if self.use_pallas:
            count("critic.fused_bn_act")
            out = self.bn1(out, train=train, fuse=(0.2, 0.0), replica=replica)
        else:
            out = act(self.bn1(out, train=train, replica=replica))
        out = run_blocks([blk for stage in self.res_layers for blk in stage], out,
                         recompute=self.remat, train=train, generator=generator,
                         replica=replica)
        features = {"res_out": to_nhwc(out)}
        out = F.avg_pool2d(out, self.cfg.pool_size)
        features["pool"] = to_nhwc(out)
        if replica.split_h > 1:
            # a stripe is not a contiguous run of the (C, H, W) flatten
            out = replica.gather(out, 2)
        out = out.reshape(out.shape[0], -1)    # (C, H, W) order: torch's flatten
        for j in range(1, self.n_linear):
            out = act(getattr(self, f"linear_{j}")(out, replica))
            if j == 1:
                features["fc1"] = out
        logit = getattr(self, f"linear_{self.n_linear}")(out, replica)
        if return_features:
            return logit, features[self.cfg.feature_tap]
        return logit
