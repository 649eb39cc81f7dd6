"""Spectral normalization by power iteration, torch-exact (port of
``vaegan_tpu/ops/spectral_norm.py``).

The reference wraps the critic's block convs and 1x1 shortcut convs in
``torch.nn.utils.spectral_norm``; its semantics, kept here:

- the weight is read as the (out_channels, -1) matrix of its OIHW layout;
- one power iteration per *training* forward updates the ``(u, v)`` buffers
  (no gradient flows through them); eval mode reuses the stored pair;
- sigma = u^T W v with u and v detached, and W / sigma is differentiable in W,
  which the WGAN gradient penalty's grad-of-grad needs.

The buffers are updated in place, as torch's are. The critic runs three train
forwards (real, fake, interpolates) before one backward, so sigma takes *copies*
of u and v: the graph of an earlier forward keeps the vectors it used, and the
next forward's in-place update does not touch them (``torch.nn.utils.spectral_norm``
clones for the same reason).
"""

from __future__ import annotations

from typing import Tuple

import torch


def l2_normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """``torch.nn.functional.normalize``: v / max(||v||, eps)."""
    return v / torch.clamp(torch.linalg.vector_norm(v), min=eps)


def spectral_normalize(weight: torch.Tensor, u: torch.Tensor, v: torch.Tensor, *,
                       update: bool, n_iterations: int = 1,
                       eps: float = 1e-12) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(weight / sigma, u, v)`` for an (O, ...) weight; with ``update`` the
    vectors are first advanced by ``n_iterations`` power iterations. The returned
    u and v are new tensors (not the buffers), detached from the graph."""
    w = weight.float().reshape(weight.shape[0], -1)
    with torch.no_grad():
        if update:
            for _ in range(n_iterations):
                v = l2_normalize(w.t() @ u, eps)
                u = l2_normalize(w @ v, eps)
        u, v = u.detach().clone(), v.detach().clone()
    sigma = u @ (w @ v)
    return weight / sigma.to(weight.dtype), u, v
