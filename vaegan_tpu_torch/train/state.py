"""Model construction and the generator state (part of the port of
``vaegan_tpu/train/state.py``; the critic, optimizers and the train step come
with the training slice).

Construction is initialization in PyTorch: :func:`build_models` draws the
weights on the CPU from a seeded ``torch.Generator`` and then moves the module,
so a seed gives the same weights on every device.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional

import torch

from vaegan_tpu_torch.config import Config, pallas_mode
from vaegan_tpu_torch.models import UnsupervisedGeneratorNetwork

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing CUDA when there is none: entry points
    default to ``"cuda"`` and run on the CPU only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def build_models(cfg: Config, device="cuda", seed: Optional[int] = None) -> UnsupervisedGeneratorNetwork:
    """The generator for ``cfg`` with weights drawn from ``seed``
    (default ``cfg.train.seed``), on ``device``.

    ``use_pallas == "all"`` fuses the res-block BN + LeakyReLU + dropout chains
    into the CUDA kernel, as in the JAX package. ``"losses"`` fuses the train-mode
    reparameterization there, which the eval-only port does not run yet.
    ``cfg.train.remat`` is accepted and ignored: recomputation in the backward
    pass is a training-memory option and the port trains nothing yet.
    """
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(cfg.train.seed if seed is None else seed)
    gen = UnsupervisedGeneratorNetwork(
        cfg.generator, init_scheme=cfg.train.init_scheme, dtype=DTYPES[cfg.train.dtype],
        use_pallas=pallas_mode(cfg.train.use_pallas) == "all", generator=g)
    return gen.to(dev)


@dataclass
class GeneratorState:
    """Generator-only state: the module (params + BN running stats), the optional
    EMA of its params (``cfg.train.ema_decay``) and the step count."""

    generator: UnsupervisedGeneratorNetwork
    ema: Optional[Dict[str, torch.Tensor]] = None
    step: int = 0

    def replace(self, **kw) -> "GeneratorState":
        return replace(self, **kw)


def create_generator_state(cfg: Config, device="cuda",
                           seed: Optional[int] = None) -> GeneratorState:
    gen = build_models(cfg, device, seed)
    ema = None
    if cfg.train.ema_decay is not None:
        ema = {k: p.detach().clone() for k, p in gen.named_parameters()}
    return GeneratorState(generator=gen, ema=ema)

