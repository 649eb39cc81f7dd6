"""The models' convolutions beyond a plain ``F.conv2d``: the convolution whose
input gradient is differentiated again by the gradient penalty
(:func:`conv2d`), and the transposed convolution of the decoder's upsample
blocks (port of ``vaegan_tpu/ops/conv.py``'s ``conv_transpose2d``).

The penalty's double backward. The penalty differentiates the critic's input
gradient in the critic's weights: at each convolution ``y = conv(x, W)`` the
inner gradient is ``gI = dgrad(gO, W)``, and the outer pass needs the
gradients of ``<ggI, gI>`` in ``gO`` and in ``W``. Autograd's own rule for
``convolution_backward`` writes the ``W`` term as a convolution with batch and
channels swapped, whose "filter" is ``gO`` at the activation's spatial size
(256x256 at the critic's first sites): no tensor-core engine of cuDNN takes
that shape. By ``<ggI, dgrad(gO, W)> = <conv(ggI, W), gO>`` the same sums are
the ordinary weight gradient of ``conv(ggI, W)`` with output gradient ``gO``,
cuDNN's wgrad at the layer's own shape, and the ``gO`` term is the forward
``conv(ggI, W)`` (:class:`InputGrad`). The weight's first-order branch stays
built-in autograd's, so a pass that asks for no weight gradient (the
penalty's inner gradient, the generator's backward through the critic) still
computes none.

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

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from vaegan_tpu_torch.utils import profiling

Pair = Tuple[int, int]


def as_channels_last(x: torch.Tensor) -> torch.Tensor:
    """``x`` with canonical channels_last strides. A tensor with one channel is
    channels_last-contiguous and NCHW-contiguous at once, and then the strides
    elementwise ops happened to give it decide which format the next convolution
    picks; this view settles it to channels_last without a copy."""
    if x.is_contiguous(memory_format=torch.channels_last):
        n, c, h, w = x.shape
        return x.as_strided(x.shape, (h * w * c, 1, w * c, c))
    return x.contiguous(memory_format=torch.channels_last)


def _pair(v: Union[int, Pair]) -> Pair:
    return (v, v) if isinstance(v, int) else tuple(v)


def _conv_backward(gy: torch.Tensor, x: torch.Tensor, w: torch.Tensor, stride: Pair,
                   padding: Pair, mask: Tuple[bool, bool, bool]):
    return torch.ops.aten.convolution_backward(gy, x, w, None, stride, padding, (1, 1),
                                               False, (0, 0), 1, mask)


def conv2d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None,
           stride: Union[int, Pair] = 1, padding: Union[int, Pair] = 0) -> torch.Tensor:
    """``F.conv2d(x, w, b, stride=stride, padding=padding)``, the same output
    and first-order gradients, whose input gradient is differentiated by
    :class:`InputGrad` (module docstring). Where autograd records no input
    gradient (grad disabled, or an ``x`` that needs none) it is the plain
    call. The input gradient is computed in every backward that reaches the
    call, also one that asks for no gradient of ``x`` (the interpolates'
    first convolution in the critic's backward), where built-in autograd
    would skip it. The penalty's convolutions run in channels_last, the
    layers' layout."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return F.conv2d(x, w, b, stride=stride, padding=padding)
    # the weight's and the bias's branch: built-in autograd, which computes
    # the weight gradient only in a pass that asks for it
    y = F.conv2d(x.detach(), w, b, stride=stride, padding=padding)
    return _InputBranch.apply(y, x, w, _pair(stride), _pair(padding))


class _InputBranch(torch.autograd.Function):
    """``y`` unchanged; in the backward, ``y``'s gradient passes through to
    the weight's branch and ``x`` takes :class:`InputGrad` of it. The weight's
    branch convolves a detached ``x``, so where the backward builds a graph
    the weight gradient's derivative in ``x`` comes back here
    (:class:`_WeightGradInX`)."""

    @staticmethod
    def forward(ctx, y, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        return y

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[1]:
            gx = InputGrad.apply(gy, x, w, ctx.stride, ctx.padding)
            if ctx.needs_input_grad[2] and torch.is_grad_enabled():
                gw = _WeightGradInX.apply(gy, x, w, ctx.stride, ctx.padding)
        return gy, gx, gw, None, None


class _WeightGradInX(torch.autograd.Function):
    """Zero in the weight's shape, whose gradient in ``x`` is the derivative in
    ``x`` of the weight gradient ``wgrad(gO, x)``: for ``ggW``, ``dgrad(gO,
    ggW)``. Added to the weight's branch, it makes the weight gradient's
    graph whole."""

    @staticmethod
    def forward(ctx, gy, x, w, stride, padding):
        ctx.save_for_backward(gy, x)
        ctx.stride, ctx.padding = stride, padding
        return w.new_zeros(()).expand(w.shape)

    @staticmethod
    def backward(ctx, ggw):
        gy, x = ctx.saved_tensors
        return None, InputGrad.apply(gy, x, ggw, ctx.stride, ctx.padding), None, None, None


class InputGrad(torch.autograd.Function):
    """``gI = dgrad(gO, W)``, the input gradient of ``conv(x, W)`` (``x`` gives
    its shape and layout only), with its own backward: for ``ggI``, the
    gradient in ``gO`` is the forward ``conv(ggI, W)`` and the one in ``W``
    the weight gradient of that forward, ``wgrad(gO, ggI)``. The weight term
    counts ``conv.penalty_wgrad``. Both are differentiable aten ops, so the
    backward is differentiable too."""

    @staticmethod
    def forward(ctx, gy, x, w, stride, padding):
        ctx.save_for_backward(gy, w)
        ctx.stride, ctx.padding = stride, padding
        return _conv_backward(gy, x, w, stride, padding, (True, False, False))[0]

    @staticmethod
    def backward(ctx, ggx):
        gy, w = ctx.saved_tensors
        ggx = as_channels_last(ggx)
        ggy = gw = None
        if ctx.needs_input_grad[0]:
            ggy = F.conv2d(ggx, w, None, stride=ctx.stride, padding=ctx.padding)
        if ctx.needs_input_grad[2]:
            profiling.count("conv.penalty_wgrad")
            gw = _conv_backward(gy, ggx, w, ctx.stride, ctx.padding,
                                (False, True, False))[1]
        return ggy, None, gw, None, None


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
