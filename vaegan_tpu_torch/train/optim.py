"""Optimizers (port of ``vaegan_tpu/train/optim.py``).

The reference trains with ``torch.optim.RMSprop(params, lr=3e-4,
weight_decay=1e-5)``; the JAX package rebuilt that optimizer as
``torch_rmsprop`` (coupled L2, eps outside the root), so here it is
``torch.optim.RMSprop`` itself:

    g   <- g + weight_decay * p
    nu  <- alpha * nu + (1 - alpha) * g^2        (``square_avg``)
    p   <- p - lr * g / (sqrt(nu) + eps)

Adam takes the weight decay coupled too (``optax.add_decayed_weights`` before
``optax.adam`` in the JAX package; ``torch.optim.Adam(weight_decay=...)`` here).
"""

from __future__ import annotations

from typing import Iterable, Optional

import torch

from vaegan_tpu_torch.config import OptimConfig


def role_lr(cfg: OptimConfig, role: Optional[str] = None) -> float:
    """``cfg.lr_g`` / ``cfg.lr_d`` for role "g" / "d" when set (the TTUR split),
    else ``cfg.lr``, the reference's one shared rate. 0.0 freezes; it is set."""
    lr = {"g": cfg.lr_g, "d": cfg.lr_d}.get(role)
    return cfg.lr if lr is None else lr


def build_optimizer(cfg: OptimConfig, params: Iterable[torch.nn.Parameter],
                    role: Optional[str] = None) -> torch.optim.Optimizer:
    lr = role_lr(cfg, role)
    if cfg.optimizer == "rmsprop":
        return torch.optim.RMSprop(params, lr=lr, alpha=cfg.rms_decay, eps=cfg.eps,
                                   weight_decay=cfg.weight_decay)
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(cfg.adam_b1, cfg.adam_b2),
                                eps=cfg.eps, weight_decay=cfg.weight_decay)
    raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
