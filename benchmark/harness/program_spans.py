"""The program's own spans and counters (``vaegan_tpu_torch.utils.profiling``)
over a traced run's window, per step or call.

The program records them while a profiler runs, so in a traced run; they lie
inside the program, where the benchmark's own spans (``trace.Spans``) lie
around its calls into it. A program that has no such recorder, or a reading
that finds no span, reads as nothing, never as zero."""

from __future__ import annotations

from typing import Callable, Optional


def per_op(run, kind: str, read: Callable) -> Optional[float]:
    """``read(profiling, t0, t1) / run.ops`` over the window ``[t0, t1]`` of a
    traced run of ``kind``; None for another kind, an untraced run, a window
    with no op, a program without the recorder, or a reading of None."""
    if run.kind != kind or run.trace is None or not run.ops:
        return None
    try:
        from vaegan_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "device_ms"):
        return None
    value = read(profiling, run.extra["t0"], run.extra["t1"])
    return None if value is None else value / run.ops


def device_ms(*names: str) -> Callable:
    """A ``read`` summing the device milliseconds of the spans ``names``
    (None when none of them carries device time)."""
    def read(profiling, t0, t1):
        parts = [profiling.device_ms(n, t0, t1) for n in names]
        return None if all(v is None for v in parts) else sum(v or 0.0 for v in parts)
    return read
