"""Functional batch normalization with torch-exact semantics (port of
``vaegan_tpu/ops/norm.py``).

Activations are NCHW tensors (channels_last in memory inside the models), so the
per-channel statistics reduce over dims (0, 2, 3). Two semantics matter:

1. the batch is normalized with the *biased* variance while the running variance
   is updated with the *unbiased* (Bessel-corrected) one,
   ``running = (1 - momentum) * running + momentum * batch``, momentum 0.1;
2. eval mode normalizes with the running statistics.

In a parallel step the statistics are global (the JAX package's
``axis_name``, or GSPMD's reduction over a batch-sharded array): given a
:class:`~vaegan_tpu_torch.ops.replica.Replica` of more than one process, the
per-channel sum and sum of squares are all-reduced, differentiably, over the
replica's ``stats_axis`` (every process under spatial sharding, whose stripes
are distinct elements; the data axis otherwise, since the model axis holds
copies of its rows), and divided by the global count, which is also the
Bessel ``n``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from vaegan_tpu_torch.ops.replica import LOCAL, Replica

_RED = (0, 2, 3)


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v.view(1, -1, 1, 1)


def batch_stats(
    x: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    *,
    use_running_average: bool,
    momentum: float = 0.1,
    replica: Replica = LOCAL,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(mean, var) used for normalization plus the updated running stats — the
    stats half of :func:`batch_norm`, exposed for the fused-kernel callers.
    Over all the processes' elements when ``replica`` spans several."""
    if use_running_average:
        return running_mean, running_var, running_mean, running_var
    xf = x.float()
    c = x.shape[1]
    n = float(x.numel() // c)
    over = replica.stats_axis
    processes = replica.axis(over)[1]
    if processes > 1:
        n *= processes
        sums = replica.all_reduce(torch.cat((xf.sum(dim=_RED), xf.square().sum(dim=_RED))),
                                  over)
        mean, mean_sq = sums[:c] / n, sums[c:] / n
    else:
        mean = xf.mean(dim=_RED)
        mean_sq = xf.square().mean(dim=_RED)
    var = mean_sq - mean.square()
    bessel = n / max(n - 1.0, 1.0)
    new_mean = ((1.0 - momentum) * running_mean + momentum * mean).to(running_mean.dtype)
    new_var = ((1.0 - momentum) * running_var + momentum * (var * bessel)).to(running_var.dtype)
    return mean, var, new_mean, new_var


def batch_norm(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    running_mean: torch.Tensor,
    running_var: torch.Tensor,
    *,
    use_running_average: bool,
    momentum: float = 0.1,
    eps: float = 1e-5,
    replica: Replica = LOCAL,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Normalize an NCHW tensor per channel. Returns ``(y, new_running_mean,
    new_running_var)``; the running stats pass through unchanged in eval mode."""
    mean, var, new_mean, new_var = batch_stats(
        x, running_mean, running_var, use_running_average=use_running_average,
        momentum=momentum, replica=replica)
    inv = torch.rsqrt(var.float() + eps)
    scale_f = scale.float()
    scale_eff = (scale_f * inv).to(x.dtype)
    bias_eff = (bias.float() - mean.float() * scale_f * inv).to(x.dtype)
    y = x * _per_channel(scale_eff) + _per_channel(bias_eff)
    return y, new_mean, new_var
