"""Evaluation-mode reconstruction in plain PyTorch, float32: the generator with
its BN running statistics, no dropout and z = mu, and the batch's MSE (the
notebook's one quantitative metric)."""

from __future__ import annotations

from typing import Tuple

import torch

from reference import model as rm
from reference.precision import computed_in


@torch.no_grad()
def reconstruct(cfg: dict, params, buffers, batch: torch.Tensor,
                precision: str = "fp32") -> Tuple[torch.Tensor, float]:
    """``(reconstructions, MSE)``, computed in ``precision`` (IEEE float32
    unless a control asks for less)."""
    with computed_in(precision, batch.device) as lower:
        net = rm.Net(params, {k: v.clone() for k, v in buffers.items()}, lower)
        recon = rm.generator(cfg, net, batch, train=False)[0]
        return recon, float(torch.mean((recon - batch) ** 2))
