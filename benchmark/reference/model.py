"""The VAE-GAN of the reference notebook in plain PyTorch, float32.

Functional: the parameters and buffers are dicts of tensors keyed by the
notebook's ``state_dict`` names, built from a configuration's plain dict (the
``config`` object of a file under ``benchmark/configs``).

Generator (the notebook's ``UnsupervisedGeneratorNetwork``): pre-activation
residual blocks, BN -> LeakyReLU(0.01) -> dropout(p) -> conv1 -> BN ->
LeakyReLU -> conv2, plus a conv + BN shortcut; ``level`` blocks are 3x3 stride
1, ``downsample`` 3x3 stride 2, ``upsample`` 4x4 stride 2 transposed; a
spatial code head (3x3 convs with bias for mu and a log-variance clamped to
the configured bound), z = mu + exp(log_var / 2) eps in training, mu in
evaluation. Dropout and noise are drawn as the fused path of the system under
test draws them (``draws``).

Critic: conv1 + BN + LeakyReLU(0.2), residual stages of spectrally normalised
3x3 convs (one power iteration per training forward, BN -> LeakyReLU -> conv1
-> channel dropout -> BN -> LeakyReLU -> conv2, a spectral 1x1 conv + BN
shortcut on a change of shape), 4x4 average pooling, a flatten in (C, H, W)
order and linear layers with LeakyReLU(0.2) to one logit. Its channel dropout
masks are drawn with ``bernoulli_`` from a device generator, one per block in
forward order.

Batch normalisation is ``F.batch_norm``: biased batch variance in training,
running statistics updated in place with the unbiased one, momentum 0.1.

``lower`` is where a lower precision enters, for the controls: hooks on the
input and the weight of every convolution and linear layer and on every
layer's output (``reference.precision.Hooks``; float32 leaves both the
identity).
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.nn.functional as F

from reference import draws as rd
from reference.precision import FP32, Hooks

Tensors = Dict[str, torch.Tensor]
Spec = List[Tuple[str, Tuple[int, ...], str]]


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------

def _conv_shape(mode: str, cin: int, cout: int) -> Tuple[int, ...]:
    if mode == "upsample":
        return (cin, cout, 4, 4)
    return (cout, cin, 3, 3)


def generator_blocks(g: dict) -> List[Tuple[str, str, int, int]]:
    """``(path, mode, in, out)`` of each residual block of the generator, in
    forward order."""
    out = []
    c, fs = g["in_channels"], g["feature_size"]
    for i in range(g["length"]):
        out.append((f"encoder.encoder.encoder-depth_0-level_{i}", "level", c, fs))
        c = fs
    for d in range(1, g["depth"] + 1):
        fs *= 2
        out.append((f"encoder.encoder.encoder-depth_{d}-downsample", "downsample", c, fs))
        c = fs
        for i in range(g["length"] - 1):
            out.append((f"encoder.encoder.encoder-depth_{d}-level_{i}", "level", c, c))
    fs = c // 2
    for d in range(g["depth"], 0, -1):
        out.append((f"decoder.decoder.decoder-depth_{d}-upsample", "upsample", c, fs))
        c = fs
        for i in range(g["length"] - 1):
            out.append((f"decoder.decoder.decoder-depth_{d}-level_{i}", "level", c, c))
        fs //= 2
    out.append(("decoder.decoder.decoder-depth_0-reconstruction", "level", c, g["in_channels"]))
    return out


def n_encoder_blocks(g: dict) -> int:
    return sum(1 for path, *_ in generator_blocks(g) if path.startswith("encoder."))


def _bn_spec(name: str, c: int) -> Spec:
    return [(f"{name}.weight", (c,), "ones"), (f"{name}.bias", (c,), "zeros"),
            (f"{name}.running_mean", (c,), "buffer_zeros"),
            (f"{name}.running_var", (c,), "buffer_ones"),
            (f"{name}.num_batches_tracked", (), "count")]


def generator_spec(cfg: dict) -> Spec:
    """Every parameter and buffer of the generator: ``(name, shape, init)``,
    the init of the reference notebook (kaiming normal on its convs; the
    transposed convs keep torch's default uniform)."""
    g = cfg["generator"]
    n_enc = n_encoder_blocks(g)
    spec: Spec = []
    for i, (path, mode, cin, cout) in enumerate(generator_blocks(g)):
        if i == n_enc:
            for head in ("mu", "log_var"):
                spec.append((f"code_processor.{head}.weight", (cin, cin, 3, 3), "kaiming_normal"))
                spec.append((f"code_processor.{head}.bias", (cin,), "zeros"))
        wkind = "uniform_fan" if mode == "upsample" else "kaiming_normal"
        spec += _bn_spec(f"{path}.bn1", cin)
        spec.append((f"{path}.conv1.weight", _conv_shape(mode, cin, cout), wkind))
        spec += _bn_spec(f"{path}.bn2", cout)
        spec.append((f"{path}.conv2.weight", (cout, cout, 3, 3), "kaiming_normal"))
        spec.append((f"{path}.shortcut.0.weight", _conv_shape(mode, cin, cout), wkind))
        spec += _bn_spec(f"{path}.shortcut.1", cout)
    return spec


def critic_stages(d: dict) -> List[Tuple[str, int, int, int]]:
    """``(path, in, out, stride)`` of each residual block of the critic."""
    out, c = [], d["num_features_conv1"]
    for i, (planes, blocks, stride) in enumerate(zip(d["num_features_res"], d["num_blocks"],
                                                     d["num_strides_res"])):
        for b in range(blocks):
            out.append((f"res_layers.{i}.{b}", c, planes, stride if b == 0 else 1))
            c = planes
    return out


def critic_flat_width(d: dict, image_size: int) -> int:
    s = -(-image_size // d["num_stride_conv1"])
    for st in d["num_strides_res"]:
        s = -(-s // st)
    s //= d["pool_size"]
    return d["num_features_res"][-1] * s * s


def _sn_spec(name: str, shape: Tuple[int, ...]) -> Spec:
    return [(f"{name}.weight_orig", shape, "uniform_fan"),
            (f"{name}.weight_u", (shape[0],), "unit_vector"),
            (f"{name}.weight_v", (math.prod(shape[1:]),), "unit_vector")]


def critic_spec(cfg: dict) -> Spec:
    """Every parameter and buffer of the critic (spectral convs keep torch's
    default uniform weight and normalised N(0, 1) vectors, as the notebook's
    ``spectral_norm`` wrapping leaves them)."""
    d = cfg["discriminator"]
    spec: Spec = [("conv1.weight", (d["num_features_conv1"], d["in_channels"], 3, 3),
                   "kaiming_normal")]
    spec += _bn_spec("bn1", d["num_features_conv1"])
    for path, cin, cout, stride in critic_stages(d):
        spec += _sn_spec(f"{path}.conv1", (cout, cin, 3, 3))
        spec += _sn_spec(f"{path}.conv2", (cout, cout, 3, 3))
        spec += _bn_spec(f"{path}.bn1", cin)
        spec += _bn_spec(f"{path}.bn2", cout)
        if stride != 1 or cout != cin:
            spec += _sn_spec(f"{path}.shortcut.0", (cout, cin, 1, 1))
            spec += _bn_spec(f"{path}.shortcut.1", cout)
    width = critic_flat_width(d, cfg["data"]["image_size"])
    for j, out in enumerate(tuple(d["linear_widths"]) + (1,)):
        spec += [(f"linear_{j + 1}.weight", (out, width), "kaiming_normal"),
                 (f"linear_{j + 1}.bias", (out,), "zeros")]
        width = out
    return spec


PARAM_KINDS = ("kaiming_normal", "uniform_fan", "ones", "zeros")


def is_param(kind: str) -> bool:
    return kind in PARAM_KINDS


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

class Net:
    """One network's tensors: ``p`` its parameters, ``b`` its buffers (updated
    in place by training forwards), ``lower`` the precision's hooks."""

    def __init__(self, p: Tensors, b: Tensors, lower: Hooks = FP32):
        self.p, self.b, self.lower = p, b, lower
        self.act = lower.act

    def conv(self, x, w, stride, pad, bias=None, transpose=False):
        lo = self.lower.operand
        if transpose:
            return self.act(F.conv_transpose2d(lo(x), lo(w), bias, stride=stride, padding=pad))
        return self.act(F.conv2d(lo(x), lo(w), bias, stride=stride, padding=pad))

    def linear(self, x, name):
        lo = self.lower.operand
        return self.act(F.linear(lo(x), lo(self.p[f"{name}.weight"]), self.p[f"{name}.bias"]))

    def bn(self, x, name, train: bool):
        return self.act(F.batch_norm(x, self.b[f"{name}.running_mean"],
                                     self.b[f"{name}.running_var"], self.p[f"{name}.weight"],
                                     self.p[f"{name}.bias"], training=train, momentum=0.1,
                                     eps=1e-5))

    def sn_weight(self, name, train: bool):
        """W / sigma, after one power iteration of (u, v) in training."""
        w = self.p[f"{name}.weight_orig"]
        wm = w.reshape(w.shape[0], -1)
        u, v = self.b[f"{name}.weight_u"], self.b[f"{name}.weight_v"]
        with torch.no_grad():
            if train:
                v = F.normalize(wm.t() @ u, dim=0, eps=1e-12)
                u = F.normalize(wm @ v, dim=0, eps=1e-12)
                self.b[f"{name}.weight_u"].copy_(u)
                self.b[f"{name}.weight_v"].copy_(v)
            u, v = u.clone(), v.clone()
        return w / (u @ (wm @ v))


def _conv_args(mode: str):
    return {"level": (1, 1, False), "downsample": (2, 1, False), "upsample": (2, 1, True)}[mode]


def res_block_vae(net: Net, x, path: str, mode: str, p: float, train: bool,
                  seed: Optional[int]):
    stride, pad, tr = _conv_args(mode)
    sc = net.bn(net.conv(x, net.p[f"{path}.shortcut.0.weight"], stride, pad, transpose=tr),
                f"{path}.shortcut.1", train)
    h = net.act(F.leaky_relu(net.bn(x, f"{path}.bn1", train), 0.01))
    if train and p > 0.0:
        keep = rd.keep_mask_nchw(h.shape, seed, p, h.device)
        h = net.act(torch.where(keep, h * (1.0 / (1.0 - p)), torch.zeros((), device=h.device)))
    h = net.conv(h, net.p[f"{path}.conv1.weight"], stride, pad, transpose=tr)
    h = net.act(F.leaky_relu(net.bn(h, f"{path}.bn2", train), 0.01))
    h = net.conv(h, net.p[f"{path}.conv2.weight"], 1, 1)
    return net.act(h + sc)


def generator(cfg: dict, net: Net, x_nhwc: torch.Tensor, train: bool,
              seeds: Optional[Iterator[int]] = None):
    """``(recon, mu, log_var)``, all (B, H, W, C) / (B, h, w, C). In training
    ``seeds`` yields the kernel seeds of the step: one per block, the noise's
    after the encoder's."""
    g = cfg["generator"]
    p = g["dropout_prob"]
    nxt = (lambda: next(seeds)) if train else (lambda: None)
    h = x_nhwc.permute(0, 3, 1, 2)
    blocks = generator_blocks(g)
    n_enc = n_encoder_blocks(g)
    for path, mode, _, _ in blocks[:n_enc]:
        h = res_block_vae(net, h, path, mode, p, train, nxt())
    lv = net.conv(h, net.p["code_processor.log_var.weight"], 1, 1,
                  net.p["code_processor.log_var.bias"])
    lv = net.act(torch.clamp(lv, -g["logvar_bound"], g["logvar_bound"]))
    mu = net.conv(h, net.p["code_processor.mu.weight"], 1, 1, net.p["code_processor.mu.bias"])
    if train:
        eps = rd.noise_nchw(mu.shape, nxt(), mu.device)
        z = net.act(mu + torch.exp(0.5 * lv) * eps)
    else:
        z = mu
    h = z
    for path, mode, _, _ in blocks[n_enc:]:
        h = res_block_vae(net, h, path, mode, p, train, nxt())
    return h.permute(0, 2, 3, 1), mu.permute(0, 2, 3, 1), lv.permute(0, 2, 3, 1)


def n_draw_sites(cfg: dict) -> int:
    """Kernel seeds a training generator forward takes: one per block, one
    for the noise."""
    return len(generator_blocks(cfg["generator"])) + 1


def critic(cfg: dict, net: Net, x_nhwc: torch.Tensor, train: bool,
           draws: Optional[torch.Generator] = None) -> torch.Tensor:
    """Logits (B, 1)."""
    d = cfg["discriminator"]
    rate = d["dropout_prob"]
    x = x_nhwc.permute(0, 3, 1, 2)
    out = net.conv(x, net.p["conv1.weight"], d["num_stride_conv1"], 1)
    out = net.act(F.leaky_relu(net.bn(out, "bn1", train), 0.2))
    for path, cin, cout, stride in critic_stages(d):
        if f"{path}.shortcut.0.weight_orig" in net.p:
            sc = net.bn(net.conv(out, net.sn_weight(f"{path}.shortcut.0", train), stride, 0),
                        f"{path}.shortcut.1", train)
        else:
            sc = out
        h = net.act(F.leaky_relu(net.bn(out, f"{path}.bn1", train), 0.2))
        h = net.conv(h, net.sn_weight(f"{path}.conv1", train), stride, 1)
        if train and rate > 0.0:
            keep = torch.empty((h.shape[0], h.shape[1], 1, 1), device=h.device).bernoulli_(
                1.0 - rate, generator=draws).bool()
            h = net.act(torch.where(keep, h / (1.0 - rate), torch.zeros((), device=h.device)))
        h = net.act(F.leaky_relu(net.bn(h, f"{path}.bn2", train), 0.2))
        h = net.conv(h, net.sn_weight(f"{path}.conv2", train), 1, 1)
        out = net.act(h + sc)
    out = net.act(F.avg_pool2d(out, d["pool_size"])).reshape(out.shape[0], -1)
    n = len(d["linear_widths"]) + 1
    for j in range(1, n):
        out = net.act(F.leaky_relu(net.linear(out, f"linear_{j}"), 0.2))
    return net.linear(out, f"linear_{n}")
