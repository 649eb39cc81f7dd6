"""Profiling and tracing (port of ``vaegan_tpu/utils/profiling.py``).

- ``trace(dir)``: context manager around ``torch.profiler.profile`` (host and,
  where there is a card, device activity) that writes a Chrome trace,
  ``<dir>/trace.json``, viewable in Perfetto or ``chrome://tracing``;
- ``annotate(name)``: a named range in that trace
  (``torch.profiler.record_function``);
- ``start_server(port)``: the JAX package's live profiler endpoint has no
  PyTorch counterpart; it raises ``NotImplementedError``;
- ``StepTimer``: steps/s and images/s with warmup excluded, synced by copying a
  metric tensor to the host.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    return torch.profiler.record_function(name)


def start_server(port: int = 9999):
    raise NotImplementedError(
        "torch.profiler has no live capture server; wrap the steps to capture in "
        "profiling.trace(dir) instead")


def _sync(value: Optional[torch.Tensor]) -> None:
    if value is not None:
        float(value)       # a device-to-host copy: waits for the work it depends on


class StepTimer:
    """Steady-state throughput with the first ``warmup`` steps excluded."""

    def __init__(self, warmup: int = 2):
        self.warmup = warmup
        self._count = 0
        # warmup=0 (a pre-warmed caller): the measured window starts now, since
        # tick() fires only after each step
        self._t0: Optional[float] = time.perf_counter() if warmup == 0 else None

    def tick(self, sync_value: Optional[torch.Tensor] = None) -> None:
        """Call once per step; pass a (small) device tensor to sync on."""
        self._count += 1
        if self._count == self.warmup:
            _sync(sync_value)
            self._t0 = time.perf_counter()

    def result(self, images_per_step: int,
               sync_value: Optional[torch.Tensor] = None) -> Dict[str, float]:
        _sync(sync_value)
        steps = self._count - self.warmup
        if self._t0 is None or steps <= 0:
            return {"steps_per_sec": 0.0, "images_per_sec": 0.0,
                    "seconds_per_step": 0.0}
        dt = time.perf_counter() - self._t0
        return {
            "steps_per_sec": steps / dt,
            "images_per_sec": steps * images_per_step / dt,
            "seconds_per_step": dt / steps,
        }
