"""Host spans and the device trace of a run.

The benchmark records its own spans around the calls it makes into the
program (``Spans``): host clock intervals, and in a traced run also profiler
user annotations (``bench.<name>``), so that an idle gap on the device can be
labelled with what the host was doing. ``reduce`` turns a ``torch.profiler``
trace of the window into the device's busy time (the union of the intervals
in which any kernel, copy or set ran: overlapping kernels count once), the
time of each kernel name and the longest idle gaps. A trace with no device
event, or whose device events stop well before the window ends, raises
:class:`TraceShort`: it never reads as an idle device.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import torch

WINDOW = "bench.window"


class TraceShort(RuntimeError):
    """The profiler recorded too little of the window to read it."""


class Spans:
    """Named host intervals (``time.perf_counter``), in order."""

    def __init__(self, traced: bool = False):
        self.traced = traced
        self.records: List[Tuple[str, float, float]] = []

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        mark = (torch.profiler.record_function(f"bench.{name}") if self.traced
                else contextlib.nullcontext())
        t0 = time.perf_counter()
        with mark:
            yield
        self.records.append((name, t0, time.perf_counter()))

    def total(self, name: str, t0: float = float("-inf"), t1: float = float("inf")) -> float:
        return sum(b - a for n, a, b in self.records if n == name and a >= t0 and b <= t1)


@dataclass
class Trace:
    busy_s: float
    window_s: float
    kernels: Dict[str, List[float]] = field(default_factory=dict)   # name -> [seconds, count]
    gaps: List[Tuple[str, float]] = field(default_factory=list)

    @property
    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def device_ops(self, n: int = 10) -> List[list]:
        top = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:n]
        return [[name[:160], secs] for name, (secs, _) in top]


def profile():
    """A profiler over the host and the card."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts, record_shapes=False, with_stack=False)


def _events(prof) -> List[Tuple[str, bool, bool, int, int]]:
    """``(name, on the device, a user annotation, start ns, end ns)`` of every
    profiler event."""
    out = []
    try:
        raw = prof.profiler.kineto_results.events()
    except AttributeError:
        raw = None
    if raw is not None:
        for e in raw:
            start = e.start_ns()
            out.append((e.name(), str(e.device_type()).endswith("CUDA"),
                        bool(e.is_user_annotation()), start, start + e.duration_ns()))
        return out
    for e in prof.events():
        out.append((e.name, str(e.device_type).endswith("CUDA"),
                    bool(getattr(e, "is_user_annotation", False)),
                    int(e.time_range.start * 1000), int(e.time_range.end * 1000)))
    return out


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def reduce(prof, idle_label: str, n_gaps: int = 10) -> Trace:
    """The window's device activity (the ``bench.window`` annotation's
    interval). Idle gaps are labelled with the innermost benchmark span that
    was open on the host when the gap began, else ``idle_label``."""
    events = _events(prof)
    windows = [(s, e) for n, dev, _, s, e in events if n == WINDOW and not dev]
    if not windows:
        raise TraceShort("the trace holds no window annotation")
    ws, we = windows[0]
    device, host = [], []
    for name, dev, ann, s, e in events:
        if dev and not ann and not name.startswith("bench."):
            s, e = max(s, ws), min(e, we)
            if e > s:
                device.append((name, s, e))
        elif not dev and name.startswith("bench.") and name != WINDOW:
            host.append((name[len("bench."):], s, e))
    if not device:
        raise TraceShort("the profiler recorded no device event in the window")
    busy = _union([(s, e) for _, s, e in device])
    if busy[-1][1] < ws + 0.9 * (we - ws):
        raise TraceShort(f"device events stop at {(busy[-1][1] - ws) / 1e9:.3f} s of a "
                         f"{(we - ws) / 1e9:.3f} s window")
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for name, s, e in device:
        kernels[name][0] += (e - s) / 1e9
        kernels[name][1] += 1
    edges = [(ws, ws)] + busy + [(we, we)]
    gaps = []
    for (_, a), (b, _) in zip(edges, edges[1:]):
        if b > a:
            open_ = [(s, n) for n, s, e in host if s <= a < e]
            gaps.append((max(open_)[1] if open_ else idle_label, (b - a) / 1e9))
    gaps.sort(key=lambda g: -g[1])
    return Trace(busy_s=sum(e - s for s, e in busy) / 1e9, window_s=(we - ws) / 1e9,
                 kernels=dict(kernels), gaps=gaps[:n_gaps])


def power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None
