"""Layers with torch-exact semantics (port of ``vaegan_tpu/models/layers.py``).

Inside the models activations are (N, C, H, W) tensors in ``torch.channels_last``
memory format: the NHWC buffer the JAX package used, with cuDNN keeping that
format through every convolution, so the fused kernel sees each BatchNorm input
as the row-major (N*H*W, C) matrix the TPU kernel saw.

Every ``forward`` takes ``train`` explicitly, as the JAX modules do; the
``nn.Module.training`` flag is not read. Parameter and buffer names follow torch's
``nn.Conv2d`` / ``nn.BatchNorm2d`` / ``nn.Linear`` and ``nn.utils.spectral_norm``
(``weight_orig``, ``weight_u``, ``weight_v``), so the generator's and the critic's
``state_dict`` have the reference notebook's key layout.

Random draws: a fused BatchNorm's dropout seed is a 64-bit int drawn from a CPU
``torch.Generator`` (``seeds``), so drawing it never waits on the device; the
unfused dropout masks are drawn on the activation's device (``generator``).
In a parallel step (``replica``, ``ops.replica``) the batch statistics are
global and every draw is the global step's, cut to this process's rows (and
H stripe). Under spatial sharding a :class:`Conv2D` takes its neighbours'
boundary rows before it convolves (:meth:`Conv2D.forward`); under tensor
parallelism a :class:`Linear` holds its rows of the kernel and gathers its
outputs over the model axis (:meth:`Linear.shard`).

Recomputation (``cfg.train.remat``, :func:`remat`): a block run under
``torch.utils.checkpoint`` runs its forward again in the backward. Its layers'
side effects then must not happen twice, and its draws must be the first
run's: the explicit generators are not among the states ``checkpoint``
restores. So the first run writes what it drew and what it wrote to a tape
(:class:`Tape`), and the rerun reads it back: a BatchNorm writes its running
statistics and draws its seed once, a spectral layer advances ``weight_u`` /
``weight_v`` once and the rerun normalizes by the first run's vectors, a
Dropout reuses the first run's mask.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from vaegan_tpu_torch.ops import conv as conv_ops
from vaegan_tpu_torch.ops.conv import as_channels_last
from vaegan_tpu_torch.ops import ieee_float32
from vaegan_tpu_torch.ops.fused import bn_act_dropout
from vaegan_tpu_torch.ops.initializers import conv_init, kaiming_normal_
from vaegan_tpu_torch.ops.norm import batch_norm, batch_stats
from vaegan_tpu_torch.ops.replica import LOCAL, Replica
from vaegan_tpu_torch.ops.spectral_norm import l2_normalize, spectral_normalize


def precision(dtype: torch.dtype):
    """:func:`ieee_float32` for a float32 model, nothing for a bfloat16 one."""
    return ieee_float32() if dtype == torch.float32 else contextlib.nullcontext()


def draw_seed(seeds: Optional[torch.Generator]) -> int:
    """A kernel seed in [0, 2**63) from a CPU generator (the global one if None)."""
    return int(torch.randint(0, 2 ** 63 - 1, (), generator=seeds))


class Tape:
    """What the first run of a recomputed block drew and computed, keyed by
    (layer, what); ``replaying`` once the first run is over."""

    def __init__(self):
        self.entries: Dict[Tuple[int, str], object] = {}
        self.replaying = False

    def once(self, layer: nn.Module, what: str, make: Callable[[], object]):
        """``make()`` on the first run, its value again on the rerun."""
        key = (id(layer), what)
        if not self.replaying:
            self.entries[key] = make()
        return self.entries[key]


def _tape(layer: nn.Module) -> Optional[Tape]:
    return layer.__dict__.get("_tape")


def _replaying(layer: nn.Module) -> bool:
    tape = _tape(layer)
    return tape is not None and tape.replaying


def _once(layer: nn.Module, what: str, make: Callable[[], object]):
    """``make()``, kept on the layer's tape when a recomputed block runs it."""
    tape = _tape(layer)
    return make() if tape is None else tape.once(layer, what, make)


def remat(block: nn.Module, x: torch.Tensor, **kw) -> torch.Tensor:
    """``block(x, **kw)`` under ``torch.utils.checkpoint`` (non-reentrant, so
    a grad-of-grad passes through it): its activations are recomputed in the
    backward instead of kept. The block's layers share a :class:`Tape` for
    the call, so the rerun repeats no side effect and redraws nothing."""
    tape = Tape()
    layers = list(block.modules())

    def run(x):
        for m in layers:
            m.__dict__["_tape"] = tape
        try:
            return block(x, **kw)
        finally:
            for m in layers:
                m.__dict__.pop("_tape", None)
            tape.replaying = True

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


class Conv2D(nn.Module):
    """``nn.Conv2d`` / ``nn.ConvTranspose2d`` (bias optional), optionally wrapped
    in ``nn.utils.spectral_norm`` (``spectral=True``: parameter ``weight_orig``,
    buffers ``weight_u``/``weight_v``, one power iteration per train forward).
    The weight is cast to the compute ``dtype`` at call time; parameters stay
    float32.

    A float32 layer convolves in IEEE float32 on the card, as the config says and
    as the JAX package's tests run it, not in the TF32 that PyTorch's cuDNN
    default would pick; faster convolutions are the ``bfloat16`` config's.
    A non-transposed layer convolves through ``ops.conv.conv2d``, which takes
    the double backward of its input gradient (the gradient penalty's) as a
    cuDNN forward and weight gradient at the layer's own shape."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, *, use_bias: bool = False,
                 transpose: bool = False, spectral: bool = False,
                 init_scheme: str = "reference", dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if spectral and transpose:
            raise ValueError("spectral norm of a transposed conv is not used by the models")
        self.stride, self.padding = stride, padding
        self.transpose, self.spectral, self.dtype = transpose, spectral, dtype
        shape = ((in_channels, out_channels) if transpose else
                 (out_channels, in_channels)) + (kernel_size, kernel_size)
        w = nn.Parameter(torch.empty(shape))
        conv_init(init_scheme, transpose=transpose, spectral=spectral)(w, generator)
        if spectral:
            self.weight_orig = w
            # torch's wrap-time init: normalized N(0, 1) vectors
            for name, dim in (("weight_u", shape[0]), ("weight_v", w[0].numel())):
                self.register_buffer(
                    name, l2_normalize(torch.randn(dim, generator=generator)))
        else:
            self.weight = w
        self.bias = nn.Parameter(torch.zeros(out_channels)) if use_bias else None

    def effective_weight(self, train: bool) -> torch.Tensor:
        """The weight the convolution uses: W / sigma for a spectral layer (whose
        train-mode call advances ``weight_u``/``weight_v`` in place), else W."""
        if not self.spectral:
            return self.weight
        if _replaying(self) and train:
            # a recompute: W / sigma by the first run's vectors, no power iteration
            u, v = _once(self, "uv", None)
            return spectral_normalize(self.weight_orig, u, v, update=False)[0]
        w, u, v = spectral_normalize(self.weight_orig, self.weight_u, self.weight_v,
                                     update=train)
        if train:
            with torch.no_grad():
                self.weight_u.copy_(u)
                self.weight_v.copy_(v)
            _once(self, "uv", lambda: (u, v))
        return w

    def forward(self, x: torch.Tensor, *, train: bool = False,
                replica: Replica = LOCAL) -> torch.Tensor:
        """The convolution of ``x`` (N, C, H, W); given a ``replica`` that splits
        H, of this process's stripe, whose output is its stripe of the output:
        the stripe is first extended by the rows of the stripes above and below
        that the kernel reads (``Replica.halo``, zeros beyond the image), and
        then convolved without padding in H."""
        w = self.effective_weight(train).to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        stride = self.stride
        if w.shape[-1] == 1 and self.padding == 0 and not self.transpose and stride > 1:
            # a strided 1x1 conv reads every stride-th pixel: subsample, then a
            # stride-1 conv (the same numbers; PyTorch's CPU double backward of a
            # strided 1x1 channels_last conv corrupts memory); a stripe starts at
            # a row that is a multiple of the stride
            _stripe_rows(x, stride, replica)
            x, stride = x[:, :, ::stride, ::stride], 1
        x = as_channels_last(x.to(self.dtype))
        with precision(self.dtype):
            if replica.split_h == 1:
                conv = conv_ops.conv_transpose2d if self.transpose else conv_ops.conv2d
                return conv(x, w, b, stride=stride, padding=self.padding)
            k, p, h = w.shape[-2], self.padding, x.shape[2]
            if self.transpose:
                # output row o reads input rows i with o = i s - p + j, j < k: the
                # stripe's outputs [s m h, s (m+1) h) read rows from m h - top to
                # (m+1) h - 1 + bottom; of the unpadded convolution of those rows
                # they are the s h rows from top s + p
                top, bottom = (k - 1 - p) // stride, (p + stride - 1) // stride
                x = as_channels_last(replica.halo(x, top, bottom))
                if conv_ops.phase_applies(w, stride, p):
                    # one halo row each side (top = bottom = 1): the rows the
                    # even and odd phases read, so no padding in H
                    return conv_ops.conv_transpose2d(x, w, b, stride, p, halo=True)
                start = top * stride + p
                if (h + top + bottom - 1) * stride + k - 2 * start == stride * h:
                    # the padding that drops `start` rows at each end keeps them
                    return F.conv_transpose2d(x, w, b, stride=stride, padding=(start, p))
                y = F.conv_transpose2d(x, w, b, stride=stride, padding=(0, p))
                return as_channels_last(y[:, :, start:start + stride * h])
            _stripe_rows(x, stride, replica)
            top, bottom = p, k - stride - p
            if bottom < 0:
                raise ValueError(f"a {k}x{k} conv at stride {stride}, padding {p} cannot run "
                                 "on a stripe")
            x = as_channels_last(replica.halo(x, top, bottom))
            return conv_ops.conv2d(x, w, b, stride=stride, padding=(0, p))


def _stripe_rows(x: torch.Tensor, stride: int, replica: Replica) -> int:
    """The rows of the stripe ``x``, which a strided layer must divide into."""
    h = x.shape[2]
    if replica.split_h > 1 and h % stride:
        raise ValueError(f"a stripe of {h} rows cannot be convolved at stride {stride}: "
                         "the stripe count must divide every stage's H")
    return h


class Linear(nn.Module):
    """``nn.Linear`` with the reference's kaiming-normal weight and zero bias;
    the weight is cast to the compute ``dtype`` at call time.

    Tensor parallelism (:meth:`shard`): the layer holds rows ``[m out/M,
    (m+1) out/M)`` of the ``[out, in]`` weight, the outputs this process
    computes, and the model axis's outputs are gathered before the bias, which
    stays whole (the JAX package shards the kernel's output features and
    replicates the bias)."""

    def __init__(self, in_features: int, out_features: int, *,
                 init_scheme: str = "reference", dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if init_scheme not in ("clean", "reference"):
            raise ValueError(f"unknown init scheme {init_scheme!r}")
        self.dtype = dtype
        self.in_features, self.out_features = in_features, out_features
        self.weight = nn.Parameter(kaiming_normal_(torch.empty(out_features, in_features),
                                                   generator))
        self.bias = nn.Parameter(torch.zeros(out_features))
        self.tp: Tuple[int, int] = (0, 1)    # (model index, model processes) of the rows held

    def rows(self, m: int, k: int) -> slice:
        """The weight rows model index ``m`` of ``k`` holds."""
        if self.out_features % k:
            raise ValueError(f"{self.out_features} output features cannot be split over {k} "
                             "processes")
        per = self.out_features // k
        return slice(m * per, (m + 1) * per)

    @torch.no_grad()
    def shard(self, m: int, k: int, opt: Optional[torch.optim.Optimizer] = None) -> None:
        """Keep rows :meth:`rows` ``(m, k)`` of the whole weight, and of its
        state in ``opt`` (the tensors of the weight's shape), in place."""
        if self.tp[1] != 1:
            raise ValueError(f"this layer already holds a slice {self.tp}")
        rows = self.rows(m, k)
        if opt is not None:
            st = opt.state.get(self.weight, {})
            for key, v in st.items():
                if isinstance(v, torch.Tensor) and v.shape == self.weight.shape:
                    st[key] = v[rows].clone()
        self.weight.data = self.weight.data[rows].clone()
        self.tp = (m, k)

    def forward(self, x: torch.Tensor, replica: Replica = LOCAL) -> torch.Tensor:
        w, b = self.weight.to(self.dtype), self.bias.to(self.dtype)
        with precision(self.dtype):
            if self.tp[1] == 1:
                return F.linear(x.to(self.dtype), w, b)
            if (replica.model_rank, replica.num_model) != self.tp:
                raise ValueError(f"this layer holds the rows of model index {self.tp[0]} of "
                                 f"{self.tp[1]}, the replica is {replica.model_rank} of "
                                 f"{replica.num_model}")
            return replica.gather(F.linear(x.to(self.dtype), w), 1) + b


class BatchNorm(nn.Module):
    """torch-exact BatchNorm2d (see ``ops.norm``).

    ``fuse=(slope, p)`` runs normalize + LeakyReLU(slope) + dropout(p) as the one
    fused pass of ``ops.fused.bn_act_dropout``, as the JAX module does: train mode
    feeds it the batch statistics (computed by differentiable torch ops, so the
    kernel's backward continues into them) and a dropout seed drawn from
    ``seeds``; eval mode feeds it the running statistics at p = 0. The last
    call's ``(seed, input shape)`` is kept as ``last_draw``, so the mask can be
    replayed (``fused.keep_mask``) to hold the fused path against the unfused one;
    in a parallel step the shape is the global input's, the draw the
    one-process step makes (this process's part of it is
    ``replica.index_map``'s).
    """

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.momentum, self.eps, self.dtype = momentum, eps, dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))
        # kept for torch's key layout; the JAX package tracks no BN step count
        self.register_buffer("num_batches_tracked", torch.zeros((), dtype=torch.long))

        self.last_draw: Optional[Tuple[int, Tuple[int, ...]]] = None

    def forward(self, x: torch.Tensor, *, train: bool,
                fuse: Optional[Tuple[float, float]] = None,
                seeds: Optional[torch.Generator] = None,
                replica: Replica = LOCAL) -> torch.Tensor:
        if fuse is None:
            y, new_mean, new_var = batch_norm(
                x.to(self.dtype), self.weight, self.bias, self.running_mean,
                self.running_var, use_running_average=not train,
                momentum=self.momentum, eps=self.eps, replica=replica)
        else:
            slope, p = fuse
            m, v, new_mean, new_var = batch_stats(
                x, self.running_mean, self.running_var, use_running_average=not train,
                momentum=self.momentum, replica=replica)
            p = float(p) if train else 0.0
            seed, base, stripe = 0, 0, None
            if p > 0.0:
                seed = _once(self, "seed", lambda: draw_seed(seeds))
                base, big_l, big_g = replica.index_map(x.shape)
                stripe = (big_l, big_g)
            if not _replaying(self):
                self.last_draw = (seed, replica.global_shape(x.shape, 2))
            y = bn_act_dropout(x.to(self.dtype), m, v, self.weight, self.bias, seed,
                               float(slope), p, float(self.eps), base, stripe)
        if train and not _replaying(self):
            # the port updates the running statistics in place
            with torch.no_grad():
                self.running_mean.copy_(new_mean)
                self.running_var.copy_(new_var)
        return y


class Dropout(nn.Module):
    """Inverted dropout; ``channelwise=True`` reproduces ``nn.Dropout2d`` (whole
    feature maps dropped). The mask is drawn from the given ``torch.Generator``
    (for the global batch, cut to this process's rows, and, elementwise, its H
    stripe, in a parallel step),
    unless a keep-mask is injected: ``mask`` (NCHW, broadcastable to the input;
    set by ``inject_masks``) overrides the draw, read-only, as the JAX module's
    ``masks`` collection does for the parity harness."""

    def __init__(self, rate: float, channelwise: bool = False):
        super().__init__()
        self.rate, self.channelwise = rate, channelwise
        self.mask: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor, *, train: bool,
                generator: Optional[torch.Generator] = None,
                replica: Replica = LOCAL) -> torch.Tensor:
        if not train or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate

        def draw():
            if self.mask is not None:
                return self.mask.to(x.device)
            shape = (x.shape[0], x.shape[1], 1, 1) if self.channelwise else x.shape
            return replica.draw(shape, lambda s: torch.empty(s, device=x.device).bernoulli_(
                keep, generator=generator), None if self.channelwise else 2)

        # a bool copy of this process's rows: what a recomputed block keeps on
        # its tape for the backward (not the float draw over the global batch)
        mask = _once(self, "mask", lambda: draw().bool())
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


@contextlib.contextmanager
def inject_masks(module: nn.Module, masks: Optional[Dict[str, torch.Tensor]]):
    """Give the :class:`Dropout` modules of ``module`` the keep-masks of
    ``masks`` (``{module path: NCHW mask}``, the reference notebook's paths) for
    the duration; an unknown path raises."""
    if not masks:
        yield
        return
    sites = {name: m for name, m in module.named_modules() if isinstance(m, Dropout)}
    unknown = sorted(set(masks) - set(sites))
    if unknown:
        raise KeyError(f"no Dropout module at {unknown[:4]}")
    try:
        for name, mask in masks.items():
            sites[name].mask = mask
        yield
    finally:
        for name in masks:
            sites[name].mask = None


def leaky_relu(x: torch.Tensor, negative_slope: float) -> torch.Tensor:
    # strict ``x > 0``, torch's subgradient convention at 0 (layers.py:181-187)
    return torch.where(x > 0, x, x * negative_slope)
