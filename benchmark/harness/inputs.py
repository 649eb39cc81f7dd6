"""What the benchmark makes from ``--seed`` and hands to both sides: the seeds
of each purpose, the images, and the initial weights (on the device, from a
generator there, in a few large draws)."""

from __future__ import annotations

import math
import zlib
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from reference import model as rm

Tensors = Dict[str, torch.Tensor]


def derive(seed: int, purpose: str) -> int:
    """A 63-bit seed for ``purpose``, a pure function of the run's seed."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), zlib.crc32(purpose.encode())])
    return int(ss.generate_state(1, np.uint64)[0]) >> 1


def make_images(n: int, size: int, seed: int, device) -> torch.Tensor:
    """``n`` single-channel ``size`` x ``size`` images in (0, 1), (N, H, W, 1):
    smooth random fields (bicubic 12 x 12 noise through a sigmoid)."""
    g = torch.Generator(device=device).manual_seed(derive(seed, "images"))
    low = torch.randn((n, 1, 12, 12), generator=g, device=device)
    img = torch.sigmoid(1.5 * F.interpolate(low, size=(size, size), mode="bicubic",
                                            align_corners=False))
    return img.permute(0, 2, 3, 1).contiguous()


def _fan_in(shape) -> int:
    return shape[1] * math.prod(shape[2:])


def make_weights(spec: rm.Spec, seed: int, device, purpose: str,
                 random_norms: bool = False) -> Tuple[Tensors, Tensors]:
    """``(parameters, buffers)`` for ``spec`` as the notebook initialises
    them: kaiming-normal convs and linears, torch's default uniform where the
    notebook keeps it, normalised N(0, 1) spectral vectors, BN weight 1 and
    bias 0, running mean 0 and variance 1. With ``random_norms`` (a served
    model) the BN affine parameters and running statistics are drawn too:
    weight U(0.8, 1.2), bias and mean U(-0.1, 0.1), variance U(0.5, 1.5)."""
    g = torch.Generator(device=device).manual_seed(derive(seed, purpose))
    normal = [e for e in spec if e[2] in ("kaiming_normal", "unit_vector")]
    uniform = [e for e in spec if e[2] == "uniform_fan"
               or (random_norms and e[2] in ("ones", "zeros", "buffer_zeros", "buffer_ones"))]
    z = torch.randn(sum(math.prod(s) for _, s, _ in normal), generator=g, device=device)
    u = torch.rand(sum(math.prod(s) for _, s, _ in uniform), generator=g, device=device)
    zs = dict(zip((n for n, _, _ in normal), z.split([math.prod(s) for _, s, _ in normal])))
    us = dict(zip((n for n, _, _ in uniform), u.split([math.prod(s) for _, s, _ in uniform])))
    span = {"ones": (0.8, 1.2), "zeros": (-0.1, 0.1), "buffer_zeros": (-0.1, 0.1),
            "buffer_ones": (0.5, 1.5)}
    params, buffers = {}, {}
    for name, shape, kind in spec:
        if kind == "kaiming_normal":
            t = zs[name].view(shape) * math.sqrt(2.0 / _fan_in(shape))
        elif kind == "unit_vector":
            t = F.normalize(zs[name], dim=0, eps=1e-12)
        elif kind == "uniform_fan":
            t = (us[name].view(shape) * 2.0 - 1.0) / math.sqrt(_fan_in(shape))
        elif kind == "count":
            t = torch.zeros(shape, dtype=torch.long, device=device)
        elif name in us:
            lo, hi = span[kind]
            t = lo + (hi - lo) * us[name].view(shape)
        else:
            fill = 1.0 if kind in ("ones", "buffer_ones") else 0.0
            t = torch.full(shape, fill, device=device)
        (params if rm.is_param(kind) else buffers)[name] = t.contiguous()
    return params, buffers


@torch.no_grad()
def load_into(module: torch.nn.Module, params: Tensors, buffers: Tensors) -> None:
    """Copy the made tensors into ``module``, whose ``state_dict`` must have
    exactly these names and shapes."""
    sd = module.state_dict()
    made = {**params, **buffers}
    if set(sd) != set(made):
        raise ValueError(f"the program's state does not have the reference's names: "
                         f"{sorted(set(sd) ^ set(made))[:6]}")
    for k, t in sd.items():
        if tuple(t.shape) != tuple(made[k].shape):
            raise ValueError(f"{k}: the program holds {tuple(t.shape)}, the reference "
                             f"{tuple(made[k].shape)}")
        t.copy_(made[k])
