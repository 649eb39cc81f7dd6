"""The yardsticks, frozen in the benchmark: the card's published peaks
(``yardstick/peaks.json``), the five hand-written kernels' bytes and
operations, and the operations a step or a call needs by the reference's
algorithm (``torch.utils.flop_counter.FlopCounterMode`` over the reference on
the meta device).

A kernel's bytes count each input read once and each output written once, the
float32 per-channel vectors and scalars included; its operations are the
algorithm's per element (a transcendental counts one, a Philox4x32-10 call
100). Its bound is the larger of bytes over the HBM rate and operations over
the float32 rate outside the tensor cores. The kernels are known by the
names of their device functions.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from reference import model as rm
from reference import train as rt
from harness.trace import TraceShort

PEAKS = json.loads((Path(__file__).resolve().parents[1] / "yardstick" / "peaks.json").read_text())

# kernel -> the device function that computes it
DEVICE_NAMES = {
    "bn_act_dropout": "bn_act_dropout_fwd_kernel",
    "bn_act_dropout_bwd": "bn_act_dropout_bwd_kernel",
    "reparam_kl": "reparam_fwd_kernel",
    "reparam_kl_bwd": "reparam_bwd_kernel",
    "recon_loss_sums": "recon_sums_kernel",
}

PHILOX_OPS = 100
# (per element, added with dropout, added for 2-byte inputs' conversions)
OPS_PER_ELEMENT = {
    "bn_act_dropout": (6, PHILOX_OPS // 4 + 5, 2),
    "bn_act_dropout_bwd": (11, PHILOX_OPS // 4 + 5, 3),
    "reparam_kl": (PHILOX_OPS // 2 + 23, 0, 3),
    "reparam_kl_bwd": (PHILOX_OPS // 2 + 24, 0, 5),
    "recon_loss_sums": (5, 0, 2),
}
# (tensors of numel elements read or written, bytes of the rest per channel or in all)
TENSORS = {"bn_act_dropout": (2, 16, True), "bn_act_dropout_bwd": (3, 32, True),
           "reparam_kl": (3, 4, False), "reparam_kl_bwd": (5, 4, False),
           "recon_loss_sums": (2, 8, False)}


def kernel_cost(name: str, numel: int, channels: int, elem_bytes: int,
                dropout: bool) -> Tuple[int, int]:
    """``(bytes, operations)`` of one call."""
    n, extra, per_channel = TENSORS[name]
    base, drop, convert = OPS_PER_ELEMENT[name]
    ops = base + (drop if dropout else 0) + (convert if elem_bytes == 2 else 0)
    return n * numel * elem_bytes + (extra * channels if per_channel else extra), ops * numel


def kernel_bound_s(name: str, numel: int, channels: int, elem_bytes: int,
                   dropout: bool) -> float:
    b, ops = kernel_cost(name, numel, channels, elem_bytes, dropout)
    return max(b / PEAKS["hbm_bytes_per_s"], ops / PEAKS["elementwise_flops_per_s"])


def peak_flops(dtype: str) -> float:
    return PEAKS["flops_per_s"][dtype]


def _meta_weights(spec):
    p = {n: torch.empty(s, device="meta") for n, s, k in spec if rm.is_param(k)}
    b = {n: torch.empty(s, device="meta") for n, s, k in spec if not rm.is_param(k)}
    return p, b


def train_step_flops(cfg: dict, batch: int) -> int:
    """Operations of one training step (the generator's forward, the critic's
    three forwards, the penalty's double backward, both backwards, the G
    half's critic forward and backward) at this batch and the configuration's
    image size."""
    from torch.utils.flop_counter import FlopCounterMode
    gp, gb = _meta_weights(rm.generator_spec(cfg))
    dp, db = _meta_weights(rm.critic_spec(cfg))
    s = cfg["data"]["image_size"]
    x = torch.empty((batch, s, s, cfg["generator"]["in_channels"]), device="meta")
    ema = {k: v for k, v in gp.items()} if cfg["train"]["ema_decay"] is not None else None
    with FlopCounterMode(display=False) as fc:
        rt.step(cfg, rt.State(gp, gb, dp, db, ema=ema), x, 0)
    return int(fc.get_total_flops())


def reconstruct_flops(cfg: dict, batch: int) -> int:
    """Operations of one evaluation-mode reconstruction."""
    from torch.utils.flop_counter import FlopCounterMode
    gp, gb = _meta_weights(rm.generator_spec(cfg))
    s = cfg["data"]["image_size"]
    x = torch.empty((batch, s, s, cfg["generator"]["in_channels"]), device="meta")
    with FlopCounterMode(display=False) as fc:
        net = rm.Net(gp, gb)
        with torch.no_grad():
            rm.generator(cfg, net, x, train=False)
    return int(fc.get_total_flops())


def fused_roofline(launches, kernels: Dict[str, list]) -> Optional[float]:
    """Share of the five kernels' device time that their bounds account for:
    the bound of each kernel's calls over the device time of that kernel's
    events, summed over the kernels. A kernel whose events the profiler
    dropped is counted over the calls its events cover, in proportion. A
    kernel that ran with no launch recorded (a launch path that bypasses the
    program's cost hook) raises :class:`TraceShort`: it would leave the
    share unseen."""
    bound, calls = {}, {}
    for name, numel, channels, elem, dropout in launches:
        bound[name] = bound.get(name, 0.0) + kernel_bound_s(name, numel, channels, elem, dropout)
        calls[name] = calls.get(name, 0) + 1
    num = den = 0.0
    for name, fn in DEVICE_NAMES.items():
        secs = sum(v[0] for k, v in kernels.items() if fn in k)
        seen = sum(v[1] for k, v in kernels.items() if fn in k)
        if name not in calls:
            if seen:
                raise TraceShort(f"{seen} device events of {fn} with no launch recorded")
            continue
        if seen < 0.5 * calls[name]:
            raise TraceShort(f"{seen} device events of {fn} for {calls[name]} launches")
        num += bound[name] * min(1.0, seen / calls[name])
        den += secs
    return 100.0 * num / den if den else None
