"""Precisions for the reference: IEEE float32, and the controls below it.

The reference itself runs with both TF32 flags off. A precision is two hooks
that the reference's layers apply (``Hooks``): ``operand`` to the input and
the weight of every convolution and linear layer, ``act`` to every layer's
output (convolutions, batch norms, activations, dropout, residual sums,
pooling, the sampled code), whose gradient then passes the same rounding in
the backward. A control computes the reference in the nearest precision below
the one its configuration states:

- ``tf32`` (below float32): on the card, cuDNN and cuBLAS with TF32 allowed,
  as PyTorch's convolution default would run them; on the CPU, every
  convolution's and linear layer's input and weight rounded to TF32's 10
  mantissa bits (nearest, ties away from zero, as the tensor cores convert);
- ``fp8`` (below bfloat16): every layer's output, and its gradient, rounded to
  bfloat16 as the configuration computes them, and besides every convolution's
  and linear layer's input and weight scaled by its largest magnitude to
  float8 e4m3's range, rounded to it and scaled back, with float32
  accumulation, as a scaled fp8 matrix product computes. No part of it is
  finer than bfloat16.

``bf16`` is the bfloat16 configuration's own precision in the reference
(every output, gradient and matrix operand through bfloat16): not a control,
a witness of what bfloat16 rounding alone does to a compared number.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, NamedTuple

import torch

E4M3_MAX = 448.0


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to 10 mantissa bits."""
    bits = t.detach().contiguous().view(torch.int32)
    r = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return t + (r - t).detach()


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` through float8 e4m3 with a per-tensor scale."""
    amax = t.detach().abs().max().clamp(min=1e-30)
    scale = amax / E4M3_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return t + (q - t).detach()


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` through bfloat16; its gradient too, in the backward."""
    return t.to(torch.bfloat16).to(t.dtype)


class Hooks(NamedTuple):
    """Where a precision enters the reference's layers."""

    operand: Callable[[torch.Tensor], torch.Tensor]
    act: Callable[[torch.Tensor], torch.Tensor]


FP32 = Hooks(_same, _same)
KINDS = {"fp32": FP32, "tf32": Hooks(round_tf32, _same), "bf16": Hooks(round_bf16, round_bf16),
         "fp8": Hooks(round_fp8, round_bf16)}


@contextlib.contextmanager
def computed_in(kind: str, device) -> Iterator[Hooks]:
    """The precision's hooks for the reference's layers, with the TF32 flags
    set for the duration: on for ``tf32`` on the card (whose hooks are then
    the identity), off otherwise."""
    cuda = torch.device(device).type == "cuda"
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    on = kind == "tf32" and cuda
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield FP32 if on else KINDS[kind]
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
