"""What the drivers share: moving state to the host in one copy per group,
the traced window, and the record a run hands to the metric readers."""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional

import torch

from harness import trace


def to_host(group: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The tensors of ``group`` on the host in float32, through one copy."""
    if not group:
        return {}
    ts = [t.detach().reshape(-1).to(torch.float32) for t in group.values()]
    flat = torch.cat(ts).cpu()
    out, at = {}, 0
    for (k, t), v in zip(group.items(), ts):
        out[k] = flat[at:at + v.numel()].view(t.shape)
        at += v.numel()
    return out


def to_host_all(groups: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, Dict[str, torch.Tensor]]:
    """Every group of ``groups`` on the host in float32, through one copy."""
    ts = [t.detach().reshape(-1).to(torch.float32) for g in groups.values() for t in g.values()]
    flat = torch.cat(ts).cpu() if ts else torch.empty(0)
    out, at = {}, 0
    for name, g in groups.items():
        out[name] = {}
        for k, t in g.items():
            out[name][k] = flat[at:at + t.numel()].view(t.shape)
            at += t.numel()
    return out


def to_device(group: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device) for k, v in group.items()}


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Run:
    """What one run measured: the numbers the metric readers take."""

    kind: str
    dtype: str
    batch: int
    setup_s: float = 0.0
    window_s: float = 0.0          # host clock, from the first call to the last result
    ops: int = 0                   # steps or calls completed in the window
    latencies: List[float] = field(default_factory=list)
    spans: Optional[trace.Spans] = None
    trace: Optional[trace.Trace] = None
    launches: List[tuple] = field(default_factory=list)
    flops_per_op: Optional[int] = None
    extra: Dict[str, object] = field(default_factory=dict)


@contextlib.contextmanager
def traced_window(traced: bool, launches: List[tuple]) -> Iterator[Optional[object]]:
    """Around the window: with ``traced``, the profiler, the window's
    annotation and a record of each hand-written kernel launch (kernel, elements,
    channels, element bytes, dropout) taken where the program launches it."""
    if not traced:
        yield None
        return
    from vaegan_tpu_torch.ops import fused
    launched = fused._launched_cost

    def record(name, x, p=0.0):
        bn = name.startswith("bn_act_dropout")
        launches.append((name, x.numel(), x.shape[1] if bn else 0, x.element_size(),
                         bn and p > 0.0))
        launched(name, x, p)

    fused._launched_cost = record
    try:
        with trace.profile() as prof:
            with torch.profiler.record_function(trace.WINDOW):
                yield prof
    finally:
        fused._launched_cost = launched
