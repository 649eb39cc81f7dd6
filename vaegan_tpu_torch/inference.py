"""Inference / evaluation API (port of ``vaegan_tpu/inference.py``).

- ``reconstruct``: eval-mode encode -> decode + the batch MSE, the reference's
  only quantitative metric;
- ``sample``: decoder-only generation from z ~ N(0, I) spatial latents;
- ``interpolate``: latent interpolation between the ``encode()`` means of two batches.

All run eval-mode semantics (BN running stats, dropout off, z = mu) under
``torch.inference_mode`` on the device the state's generator lives on. Images are
(B, H, W, C) and latents (B, h, w, C), as in the JAX package; numpy arrays and
tensors are both accepted and tensors are returned. The BN-statistics
recalibration waits for the training slice, which brings train-mode fused BN.
"""

from __future__ import annotations

import copy
import itertools
from typing import Optional, Tuple

import numpy as np
import torch

from vaegan_tpu_torch.config import Config
from vaegan_tpu_torch.models import UnsupervisedGeneratorNetwork
from vaegan_tpu_torch.train.state import GeneratorState, resolve_device


def _device(state: GeneratorState) -> torch.device:
    return next(state.generator.parameters()).device


def _as_input(a, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a,
                           dtype=torch.float32, device=device)


@torch.inference_mode()
def eval_reconstruct(cfg: Config, gen: UnsupervisedGeneratorNetwork,
                     batch: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eval-mode reconstruction + the reference's one-batch MSE, taken in float32.
    Shared by :func:`reconstruct` and the serving bundle, so the served metric's
    definition lives in one place."""
    out = gen(batch, train=False)
    recon = out[0] if cfg.generator.is_vae else out
    mse = torch.mean(torch.square(recon.float() - batch.float()))
    return recon, mse


def reconstruct(cfg: Config, state: GeneratorState, batch) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (reconstructions, scalar float32 MSE)."""
    return eval_reconstruct(cfg, state.generator, _as_input(batch, _device(state)))


def with_ema(state: GeneratorState) -> GeneratorState:
    """View of ``state`` whose generator params are the EMA iterate
    (``cfg.train.ema_decay``): a copy of the module with the EMA params loaded;
    the BN running statistics are the live ones, as in the JAX package."""
    if state.ema is None:
        raise ValueError("state carries no generator EMA — set "
                         "cfg.train.ema_decay to maintain one during training")
    gen = copy.deepcopy(state.generator)
    params = dict(gen.named_parameters())
    if set(state.ema) != set(params):
        raise ValueError("the EMA's keys do not match the generator's params")
    with torch.no_grad():
        for k, v in state.ema.items():
            params[k].copy_(v)
    return state.replace(generator=gen)


def latent_shape(cfg: Config, image_size: Optional[int] = None) -> Tuple[int, int, int]:
    """Spatial latent (h, w, C') for the resolution: the encoder divides by
    2**depth; channels = feature_depth."""
    s = image_size or cfg.data.image_size
    f = 2 ** cfg.generator.depth
    return (s // f, s // f, cfg.generator.feature_depth)


@torch.inference_mode()
def sample(cfg: Config, state: GeneratorState, generator: Optional[torch.Generator] = None,
           n: int = 25, image_size: Optional[int] = None,
           z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Decode prior samples into images. ``z`` (n, h, w, C') is used when given;
    otherwise z ~ N(0, I) is drawn from ``generator`` (on the generator's device,
    then moved to the model's)."""
    dev = _device(state)
    if z is None:
        if generator is None:
            raise ValueError("sample needs a torch.Generator or an explicit z")
        h, w, c = latent_shape(cfg, image_size)
        z = torch.randn((n, h, w, c), generator=generator, device=generator.device)
    return state.generator.decode(_as_input(z, dev))


@torch.inference_mode()
def interpolate(cfg: Config, state: GeneratorState, x1, x2, steps: int = 8) -> torch.Tensor:
    """Linear interpolation in latent space between encode(x1) and encode(x2);
    returns (steps, B, H, W, C) decoded images."""
    dev = _device(state)
    x1, x2 = _as_input(x1, dev), _as_input(x2, dev)
    if x1.shape[0] == 0 or x2.shape[0] == 0 or x1.shape != x2.shape:
        raise ValueError(
            f"interpolate needs two equal non-empty batches, got {tuple(x1.shape)} and "
            f"{tuple(x2.shape)} (a batch of at least 2 images is required to take both "
            "endpoints from one batch)")
    gen = state.generator
    z1, z2 = gen.encode(x1), gen.encode(x2)
    ts = torch.linspace(0.0, 1.0, steps, device=dev).view(steps, 1, 1, 1, 1)
    zs = (1.0 - ts) * z1[None] + ts * z2[None]          # (steps, B, h, w, c)
    imgs = gen.decode(zs.reshape((-1,) + tuple(z1.shape[1:])))
    return imgs.reshape((steps,) + tuple(x1.shape))


def mean_predictor_floor(batch, device="cuda") -> float:
    """MSE of predicting each image's own mean: the mean per-image variance, the
    floor that eval-MSE numbers are read against. A tensor is reduced on its own
    device; anything else is moved to ``device`` first."""
    dev = batch.device if isinstance(batch, torch.Tensor) else resolve_device(device)
    b = _as_input(batch, dev)
    return float(b.var(dim=tuple(range(1, b.dim())), unbiased=False).mean())


def evaluate_mse(cfg: Config, state: GeneratorState, loader, num_batches: int = 1) -> float:
    """Reference eval protocol: mean MSE over ``num_batches`` loader batches."""
    total, n = 0.0, 0
    # islice: never pulls (and loses) a batch past the budget from an iterator
    for batch in itertools.islice(iter(loader), num_batches):
        _, mse = reconstruct(cfg, state, batch)
        total += float(mse)
        n += 1
    if n == 0:
        # a silent 0.0 would rank as a perfect score downstream
        raise ValueError("evaluate_mse got an empty loader (no batches); "
                         "check root_dir / dataset size vs batch_size")
    return total / n
