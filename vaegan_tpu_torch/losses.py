"""Loss functions, torch-reduction-exact (port of ``vaegan_tpu/losses.py``).

Reference semantics:
- pixel reconstruction = L1Loss() + MSELoss(), both mean-reduced;
- KL summed over batch AND all spatial-latent dims (the notebook's trailing
  ``.mean()`` acts on a scalar); ``reduction="mean"`` divides by the batch size;
- WGAN critic loss -E[D(real)] + E[D(fake)] with the gradient penalty of
  Gulrajani et al.;
- BCE adversarial + Dis_l feature-matching reconstruction for the Larsen et al.
  configuration.

Every loss is taken in float32, whatever the compute dtype.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred.float() - target.float()))


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred.float() - target.float()))


def pixel_reconstruction_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """L1 + MSE, the reference's ``reconstruction_loss_funs``."""
    return l1_loss(pred, target) + mse_loss(pred, target)


def kl_divergence(mu: torch.Tensor, log_var: torch.Tensor,
                  reduction: str = "sum") -> torch.Tensor:
    """-0.5 * sum(1 + log_var - mu^2 - exp(log_var)); ``"sum"`` reduces over batch
    and dims (the reference), ``"mean"`` divides by the batch size."""
    mu, log_var = mu.float(), log_var.float()
    kl = -0.5 * torch.sum(1.0 + log_var - torch.square(mu) - torch.exp(log_var))
    if reduction == "sum":
        return kl
    if reduction == "mean":
        return kl / mu.shape[0]
    raise ValueError(f"unknown kl reduction {reduction!r}")


def bce_with_logits(logits: torch.Tensor, target: float) -> torch.Tensor:
    """Numerically stable BCE on logits against a constant target (0. or 1.),
    mean-reduced, as ``torch.nn.BCEWithLogitsLoss``."""
    x = logits.float()
    return torch.mean(torch.clamp(x, min=0.0) - x * float(target)
                      + torch.log1p(torch.exp(-torch.abs(x))))


def wgan_critic_loss(real_logits: torch.Tensor,
                     fake_logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(real_loss, fake_loss) = (-E[D(real)], +E[D(fake)])."""
    return -torch.mean(real_logits.float()), torch.mean(fake_logits.float())


def wgan_generator_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    """-E[D(fake)]."""
    return -torch.mean(fake_logits.float())


def feature_matching_loss(real_features: torch.Tensor,
                          fake_features: torch.Tensor) -> torch.Tensor:
    """Dis_l reconstruction loss (Larsen et al. §3): MSE in the critic's feature
    space."""
    return mse_loss(fake_features, real_features)


def gradient_penalty(critic: Callable[[torch.Tensor], torch.Tensor], real: torch.Tensor,
                     fake: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """WGAN-GP: E[(||d D(x_hat) / d x_hat||_2 - 1)^2] at x_hat = alpha * real +
    (1 - alpha) * fake, with a per-sample ``alpha`` (B, 1, 1, 1) and the norm over
    each sample's flattened dims, sqrt(sum g^2 + 1e-24).

    ``critic`` maps (B, H, W, C) images to per-sample logits; the gradient is
    taken with ``create_graph=True``, so differentiating the penalty in the
    critic's parameters is a grad-of-grad. A train-mode critic advances its BN
    statistics and spectral (u, v) in this forward, as the reference's does."""
    b = real.shape[0]
    alpha = alpha.float().reshape(b, 1, 1, 1)
    interp = (alpha * real.float() + (1.0 - alpha) * fake.float()).to(real.dtype)
    interp.requires_grad_(True)
    logits = critic(interp)
    (grads,) = torch.autograd.grad(logits.float().sum(), interp, create_graph=True)
    grads = grads.reshape(b, -1).float()
    norms = torch.sqrt(torch.sum(torch.square(grads), dim=1) + 1e-24)
    return torch.mean(torch.square(norms - 1.0))
