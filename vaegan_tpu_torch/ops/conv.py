"""The transposed convolution of the decoder's upsample blocks (port of
``vaegan_tpu/ops/conv.py``'s ``conv_transpose2d``).

A transposed convolution with kernel 4, stride 2 and padding 1 can be computed
as a phase decomposition: each of the four output phases (even or odd row,
even or odd column) is a stride-1 2x2 convolution over the input with the
kernel taps that reach it, and a depth-to-space interleave puts the four
results together. The sums are the same, grouped differently, and no work is
spent on the zeros that the dilated form inserts between input pixels. With
:data:`PHASE_DECOMPOSE_CONV_TRANSPOSE` off (the default, as in the JAX package)
:func:`conv_transpose2d` is ``F.conv_transpose2d``. The flag is read at call
time. The four convolutions are cuDNN's: in the JAX package they sit outside
any Pallas kernel too.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

# opt-in alternative for k4/s2/p1 transposed convs (see conv_transpose2d)
PHASE_DECOMPOSE_CONV_TRANSPOSE = False

# the kernel rows (and columns) of each output phase, in the order the phase's
# 2x2 convolution reads its input rows: even outputs 2m read x[m-1] with tap 3
# and x[m] with tap 1, odd outputs 2m+1 read x[m] with tap 2 and x[m+1] with tap 0
_TAPS = ((3, 1), (2, 0))


def phase_applies(w: torch.Tensor, stride: int, padding: int) -> bool:
    """Whether :func:`conv_transpose2d` takes the phase path for this weight
    (``ConvTranspose2d`` layout ``(I, O, kH, kW)``), stride and padding."""
    return (PHASE_DECOMPOSE_CONV_TRANSPOSE and stride == 2 and padding == 1
            and tuple(w.shape[-2:]) == (4, 4))


def conv_transpose2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
                     stride: int = 2, padding: int = 1, *, halo: bool = False) -> torch.Tensor:
    """``F.conv_transpose2d(x, w, b, stride=stride, padding=padding)`` of ``x``
    (N, C, H, W), ``w`` in ``ConvTranspose2d`` layout (I, O, kH, kW): through the
    phase decomposition where :func:`phase_applies`, else directly. ``halo``:
    ``x`` is a stripe that already holds the row above and the row below that
    the phase convolutions read (zeros beyond the image), and the output is the
    stripe's 2 (H - 2) rows; only the phase path takes it."""
    if phase_applies(w, stride, padding):
        return _phase2(x, w, b, halo)
    if halo:
        raise ValueError("conv_transpose2d: a stripe with its halo takes the phase path only")
    return F.conv_transpose2d(x, w, b, stride=stride, padding=padding)


def _phase2(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
            halo: bool) -> torch.Tensor:
    """k=4, s=2, p=1 transposed conv as four stride-1 2x2 convs and an
    interleave. Per axis, padding the input by one on each side, the even phase
    reads rows [0, H+1) of it and the odd phase rows [1, H+2)."""
    xp = F.pad(x, (1, 1, 0, 0) if halo else (1, 1, 1, 1))
    h, wd = xp.shape[2] - 2, xp.shape[3] - 2
    phases = []
    for pr in (0, 1):
        rows = w[:, :, list(_TAPS[pr])]
        for pc in (0, 1):
            k = rows[:, :, :, list(_TAPS[pc])].transpose(0, 1)      # (O, I, 2, 2)
            y = F.conv2d(xp[:, :, pr:pr + h + 1, pc:pc + wd + 1], k, b)
            phases.append(y.permute(0, 2, 3, 1))                     # (N, H, W, O)
    n, o = x.shape[0], w.shape[1]
    # phases ordered (even, even), (even, odd), (odd, even), (odd, odd)
    out = torch.stack(phases, dim=3).reshape(n, h, wd, 2, 2, o)
    out = out.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h, 2 * wd, o)
    return out.permute(0, 3, 1, 2)                                   # channels_last
