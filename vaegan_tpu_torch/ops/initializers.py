"""Weight initializers reproducing the reference's init quirks (port of
``vaegan_tpu/ops/initializers.py``).

The reference's ``init_weights`` applies kaiming-normal to ``nn.Conv2d`` /
``nn.Linear`` weights and zeroes biases; BatchNorm gets weight 1 / bias 0.
``isinstance(module, nn.Conv2d)`` misses ``ConvTranspose2d``, so under
``scheme="reference"`` upsample kernels keep torch's *default* init,
kaiming-uniform with a=sqrt(5), whose fan-in torch reads from dim 1 of the
(in, out, kh, kw) weight: ``out_channels * kh * kw``. ``scheme="clean"`` applies
kaiming-normal everywhere.

Weights are in torch layout: (O, I, KH, KW) for a conv, (I, O, KH, KW) for a
transposed conv. Every draw takes an explicit ``torch.Generator``; the values
cannot match the JAX package's RNG, only the distributions do.
"""

from __future__ import annotations

import math

import torch


def fan_in(shape) -> int:
    """torch's ``_calculate_fan_in_and_fan_out`` fan-in: dim 1 times the
    receptive field (so the in-channels of a conv, the out-channels of a
    transposed conv)."""
    return shape[1] * math.prod(shape[2:])


@torch.no_grad()
def kaiming_normal_(w: torch.Tensor, generator: torch.Generator,
                    fan: int | None = None) -> torch.Tensor:
    """torch ``kaiming_normal_`` defaults: fan_in mode, leaky_relu gain sqrt(2)."""
    std = math.sqrt(2.0) / math.sqrt(fan or fan_in(w.shape))
    return w.normal_(0.0, std, generator=generator)


def _kaiming_normal_transposed_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    # the JAX package's "clean" kaiming reads the fan-in off its HWIO kernel:
    # the in-channels, which are dim 0 of a transposed conv's torch weight
    return kaiming_normal_(w, generator, fan=w.shape[0] * math.prod(w.shape[2:]))


@torch.no_grad()
def torch_default_conv_(w: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """torch's conv default: kaiming_uniform_(a=sqrt(5)) => U(-b, b), b = 1/sqrt(fan_in)."""
    bound = 1.0 / math.sqrt(fan_in(w.shape))
    return w.uniform_(-bound, bound, generator=generator)


def conv_init(scheme: str, *, transpose: bool = False):
    """Initializer for a conv weight under the given scheme."""
    if scheme == "clean":
        return _kaiming_normal_transposed_ if transpose else kaiming_normal_
    if scheme == "reference":
        return torch_default_conv_ if transpose else kaiming_normal_
    raise ValueError(f"unknown init scheme {scheme!r}")
