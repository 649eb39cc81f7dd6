"""Models and the train state (port of ``vaegan_tpu/train/state.py``).

Construction is initialization in PyTorch: :func:`build_models` draws the
weights on the CPU from a seeded ``torch.Generator`` (the generator's first,
then the critic's, from one stream) and then moves the modules, so a seed gives
the same weights on every device.

The JAX package's ``TrainState`` is a pure pytree that each step returns anew;
here it holds the two modules (parameters, BN running statistics, spectral
(u, v) buffers), the two ``torch.optim`` optimizers and their state, the step
count, the stale G metrics and the optional generator EMA, and a step updates
it in place.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Tuple

import torch

from vaegan_tpu_torch.config import Config, pallas_mode
from vaegan_tpu_torch.models import Discriminator, UnsupervisedGeneratorNetwork
from vaegan_tpu_torch.train.optim import build_optimizer

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
G_METRICS = ("g_loss", "adv_loss", "recon_loss", "kl")


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing CUDA when there is none: entry points
    default to ``"cuda"`` and run on the CPU only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def uses_gp(cfg: Config) -> bool:
    """Whether the config trains with the WGAN gradient penalty."""
    return cfg.loss.adversarial == "wgan" and cfg.loss.lambda_gp > 0.0


def _generator(cfg: Config, g: torch.Generator) -> UnsupervisedGeneratorNetwork:
    mode = pallas_mode(cfg.train.use_pallas)
    return UnsupervisedGeneratorNetwork(
        cfg.generator, init_scheme=cfg.train.init_scheme, dtype=DTYPES[cfg.train.dtype],
        use_pallas=mode == "all", fuse_reparam=mode in ("losses", "all"), generator=g,
        remat=cfg.train.remat)


def build_generator(cfg: Config, device="cuda",
                    seed: Optional[int] = None) -> UnsupervisedGeneratorNetwork:
    """The generator of :func:`build_models` alone (the same weights for the
    same seed), for serving, which needs no critic."""
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(cfg.train.seed if seed is None else seed)
    return _generator(cfg, g).to(dev)


def build_models(cfg: Config, device="cuda", seed: Optional[int] = None
                 ) -> Tuple[UnsupervisedGeneratorNetwork, Discriminator]:
    """``(generator, critic)`` for ``cfg`` with weights drawn from ``seed``
    (default ``cfg.train.seed``), on ``device``.

    ``use_pallas == "all"`` fuses the generator's res-block BN + LeakyReLU +
    dropout chains into the CUDA kernel, as in the JAX package; ``"losses"`` and
    ``"all"`` fuse the train-mode reparameterization (``reparam_kl``) and the G
    half's pixel loss (``recon_loss_sums``). The critic fuses its BN + LeakyReLU
    chains only when no gradient penalty is configured: the kernel's backward is
    not twice-differentiable, and the penalty takes a grad-of-grad through the
    critic. ``cfg.train.remat`` recomputes every residual block of both
    networks in the backward (``models.layers.remat``), as the JAX package's
    ``nn.remat`` does.
    """
    dev = resolve_device(device)
    g = torch.Generator().manual_seed(cfg.train.seed if seed is None else seed)
    gen = _generator(cfg, g)
    critic = Discriminator(
        cfg.discriminator, cfg.data.image_size, init_scheme=cfg.train.init_scheme,
        dtype=DTYPES[cfg.train.dtype],
        use_pallas=pallas_mode(cfg.train.use_pallas) == "all" and not uses_gp(cfg),
        generator=g, remat=cfg.train.remat)
    return gen.to(dev), critic.to(dev)


def tp_linears(critic: Discriminator, num_model: int):
    """``(name, layer)`` of each critic ``linear_*`` whose kernel tensor
    parallelism over ``num_model`` processes splits: the JAX rule
    (``vaegan_tpu/parallel/mesh.py:86-91``), every 2-D ``linear_*`` kernel whose
    output width divides by the process count (at the notebook's widths
    ``linear_1``-``linear_3``; ``linear_4``, one output, stays whole)."""
    return [(f"linear_{j}", getattr(critic, f"linear_{j}"))
            for j in range(1, critic.n_linear + 1)
            if getattr(critic, f"linear_{j}").out_features % num_model == 0]


@dataclass
class GeneratorState:
    """Generator-only state: the module (params + BN running stats), the optional
    EMA of its params (``cfg.train.ema_decay``) and the step count."""

    generator: UnsupervisedGeneratorNetwork
    ema: Optional[Dict[str, torch.Tensor]] = None
    step: int = 0

    def replace(self, **kw) -> "GeneratorState":
        return replace(self, **kw)


def _ema_of(gen: UnsupervisedGeneratorNetwork) -> Dict[str, torch.Tensor]:
    return {k: p.detach().clone() for k, p in gen.named_parameters()}


def create_generator_state(cfg: Config, device="cuda",
                           seed: Optional[int] = None) -> GeneratorState:
    gen = build_generator(cfg, device, seed)
    return GeneratorState(generator=gen,
                          ema=_ema_of(gen) if cfg.train.ema_decay is not None else None)


@dataclass
class TrainState:
    """Everything a train step of either scheme reads and updates (in place)."""

    generator: UnsupervisedGeneratorNetwork
    critic: Discriminator
    opt_g: torch.optim.Optimizer
    opt_d: torch.optim.Optimizer
    step: int = 0
    # the last G half's metrics: the reference prints stale G values on
    # critic-only steps, and the step reports them the same way
    g_metrics: Dict[str, torch.Tensor] = field(default_factory=dict)
    g_ema: Optional[Dict[str, torch.Tensor]] = None

    def replace(self, **kw) -> "TrainState":
        return replace(self, **kw)


def create_train_state(cfg: Config, device="cuda", seed: Optional[int] = None) -> TrainState:
    """Models, optimizers (RMSprop or Adam with the ``lr_g``/``lr_d`` split),
    zero G metrics and the EMA when ``cfg.train.ema_decay`` is set.

    Both schemes keep one ``opt_g`` over all the generator's parameters. The JAX
    package's three-optimizer state holds two instances of one transformation,
    ``opt_g = {"enc", "dec"}``; RMSprop and Adam (decay coupled) are elementwise
    with a step count per parameter, so one optimizer over both groups, stepped
    once with both groups' gradients, is exactly that pair, and the state and
    its checkpoints have one layout for both schemes."""
    if cfg.optim.scheme not in ("two", "three"):
        raise ValueError(f"optim.scheme must be 'two' or 'three', got {cfg.optim.scheme!r}")
    gen, critic = build_models(cfg, device, seed)
    dev = next(gen.parameters()).device
    return TrainState(
        generator=gen, critic=critic,
        opt_g=build_optimizer(cfg.optim, gen.parameters(), "g"),
        opt_d=build_optimizer(cfg.optim, critic.parameters(), "d"),
        g_metrics={k: torch.zeros((), device=dev) for k in G_METRICS},
        g_ema=_ema_of(gen) if cfg.train.ema_decay is not None else None)
