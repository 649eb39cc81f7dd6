"""Profiling and tracing (port of ``vaegan_tpu/utils/profiling.py``).

- ``trace(dir)``: context manager around ``torch.profiler.profile`` (host and,
  where there is a card, device activity) that writes a Chrome trace,
  ``<dir>/trace.json``, viewable in Perfetto or ``chrome://tracing``;
- ``span(name, device=False, **attrs)`` / ``count(name, n=1, **attrs)``: the
  program's spans and counters (below);
- ``start_server(port, log_dir)`` / ``stop_server()``: a live capture endpoint,
  the counterpart of ``jax.profiler.start_server``: an HTTP server on
  127.0.0.1 whose ``GET /capture?duration_ms=N`` records ``torch.profiler``
  over the next N ms of whatever the process runs, on every thread (the CPU,
  and the card's kernels where there is one), writes
  ``<log_dir>/capture_<n>/trace.json`` and answers ``{"path", "cpu_events",
  "device_events"}`` as JSON;
- ``StepTimer``: steps/s and images/s with warmup excluded, synced by copying a
  metric tensor to the host.

Spans and counters. The training loop, the step, the metric flush, the device
loader and ``inference.reconstruct`` open named spans (``loop.step``,
``step.d_backward``, ``metrics.copy``, ``serve.reconstruct``, ...) and count
their host syncs (``count("host_sync", where=...)``). Recording is on while
any ``torch.profiler`` runs, on whichever thread started it (so every trace
that :func:`trace`, :func:`capture` and the capture endpoint take carries them,
as ``vaegan.<name>`` ranges on the profiler's own clock) and between :func:`enable` and :func:`disable` (or
inside :func:`tracing`), which keeps them in memory without a profiler. Off, a
span costs one check of those two flags and records nothing: no
``record_function``, no CUDA event, no record.

On, a span keeps a :class:`SpanRecord`: its name, the span open on the same
thread when it opened (its parent), its attributes (a child without its own
carries its parent's, so the phases of a step carry the loop's ``step=``), and
its host interval from ``time.perf_counter_ns()``. A span given a CUDA device
(``device=batch.device``) also records a pair of timing events on that
device's current stream; they are
read only by :func:`device_ms`, after the fact, so a step still never waits
for the card. At most ``CAPACITY`` spans and as many counts are kept; the
oldest go first and :func:`dropped` says how many went.
"""

from __future__ import annotations

import contextlib
import http.server
import json
import os
import tempfile
import threading
import time
import urllib.parse
from collections import deque
from typing import Dict, Iterator, List, Optional, Tuple

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


# ---------------------------------------------------------------------------
# the program's spans and counters (module docstring)
# ---------------------------------------------------------------------------

CAPACITY = 65_536
PREFIX = "vaegan."
_profiler_enabled = torch._C._autograd._profiler_enabled
_autograd_profiler = torch.autograd.profiler


def _profiling() -> bool:
    """Whether a ``torch.profiler`` runs, on this thread or on any other: the
    thread-local state is set only on the thread that started it, so a
    capture of every thread started elsewhere (the capture endpoint's) shows
    only in the flag the profiler sets on start."""
    return _autograd_profiler._is_profiler_enabled or _profiler_enabled()


class SpanRecord:
    """One closed span: ``name``, ``parent`` (the record of the span open on
    the same thread when it opened, or None), ``attrs``, host ``t0_ns`` /
    ``t1_ns`` (``time.perf_counter_ns``) and ``events``, its (start, end)
    CUDA timing events or None."""

    __slots__ = ("name", "parent", "attrs", "t0_ns", "t1_ns", "events")

    def __init__(self, name: str, parent: Optional["SpanRecord"], attrs: dict):
        self.name, self.parent, self.attrs = name, parent, attrs
        self.t0_ns = self.t1_ns = 0
        self.events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None


class CountRecord:
    """One counter increment: ``name``, ``n``, ``attrs``, host ``t_ns`` and
    ``span``, the record of the span open on its thread."""

    __slots__ = ("name", "n", "attrs", "t_ns", "span")

    def __init__(self, name: str, n: int, attrs: dict, t_ns: int,
                 span: Optional[SpanRecord]):
        self.name, self.n, self.attrs, self.t_ns, self.span = name, n, attrs, t_ns, span


class _Recorder:
    """The process's rings of spans and counts, and whether recording is on
    without a profiler."""

    def __init__(self):
        self.on = False
        self.lock = threading.Lock()
        self.local = threading.local()
        self.clear()

    def clear(self) -> None:
        with self.lock:
            self.spans: deque = deque(maxlen=CAPACITY)
            self.counts: deque = deque(maxlen=CAPACITY)
            self.dropped = {"spans": 0, "counts": 0}

    def open_spans(self) -> List[SpanRecord]:
        stack = getattr(self.local, "stack", None)
        if stack is None:
            stack = self.local.stack = []
        return stack

    def keep(self, ring: str, rec) -> None:
        with self.lock:
            kept = getattr(self, ring)
            if len(kept) == CAPACITY:
                self.dropped[ring] += 1
            kept.append(rec)


_REC = _Recorder()


def enable() -> None:
    """Record spans and counts in memory from now on, with or without a profiler."""
    _REC.on = True


def disable() -> None:
    """Record only while a profiler runs (the default)."""
    _REC.on = False


@contextlib.contextmanager
def tracing() -> Iterator[None]:
    """Record spans and counts in memory inside the block."""
    was, _REC.on = _REC.on, True
    try:
        yield
    finally:
        _REC.on = was


def clear() -> None:
    """Forget every kept span and count, and the dropped counts."""
    _REC.clear()


def dropped() -> Dict[str, int]:
    """How many spans and counts the rings have let go, oldest first."""
    return dict(_REC.dropped)


def _stream(device) -> Optional[torch.cuda.Stream]:
    """The current stream of ``device`` when it is a CUDA device, else None."""
    if device is False or torch.device(device).type != "cuda":
        return None
    return torch.cuda.current_stream(device)


def _timing_event() -> torch.cuda.Event:
    return torch.cuda.Event(enable_timing=True)


class span:
    """A named span of the program (module docstring)::

        with profiling.span("step.d_backward", device=batch.device):
            ...

    ``device``: the device the span's work runs on; on a CUDA device its
    timing events are recorded on that device's current stream. ``attrs``:
    what the span belongs to, such as ``step=global_step`` or ``call=n``."""

    __slots__ = ("name", "device", "attrs", "_rec", "_mark", "_stream")

    def __init__(self, name: str, device=False, **attrs):
        self.name, self.device, self.attrs = name, device, attrs
        self._rec = None

    def __enter__(self) -> "span":
        if _REC.on or _profiling():
            self._open()
        return self

    def _open(self) -> None:
        stack = _REC.open_spans()
        parent = stack[-1] if stack else None
        # a child with no attributes of its own shares its parent's (and so
        # sees a later tag() of it)
        attrs = self.attrs
        if parent is not None:
            attrs = {**parent.attrs, **attrs} if attrs else parent.attrs
        rec = self._rec = SpanRecord(self.name, parent, attrs)
        stack.append(rec)
        rec.t0_ns = time.perf_counter_ns()
        self._mark = None
        if _profiling():
            self._mark = torch.profiler.record_function(PREFIX + self.name)
            self._mark.__enter__()
        self._stream = _stream(self.device)
        if self._stream is not None:
            rec.events = (_timing_event(), _timing_event())
            rec.events[0].record(self._stream)

    def tag(self, **attrs) -> None:
        """Change the open span's attributes, and so those of its children
        that carry them (``step=None``: the span ran no step after all). Off,
        nothing. Tag a span opened with attributes of its own: one without
        shares its parent's, and a tag would change the parent's too."""
        if self._rec is not None:
            self._rec.attrs.update(attrs)

    def __exit__(self, *exc) -> bool:
        rec = self._rec
        if rec is None:
            return False
        self._rec = None
        if rec.events is not None:
            rec.events[1].record(self._stream)
        if self._mark is not None:
            self._mark.__exit__(*exc)
        rec.t1_ns = time.perf_counter_ns()
        stack = _REC.open_spans()
        if stack and stack[-1] is rec:
            stack.pop()
        elif rec in stack:
            stack.remove(rec)
        _REC.keep("spans", rec)
        return False


def count(name: str, n: int = 1, **attrs) -> None:
    """Count ``n`` of ``name`` (``host_sync`` with ``where=...``: a copy that
    waits for the card) at this time, in the span open on this thread."""
    if not (_REC.on or _profiling()):
        return
    stack = _REC.open_spans()
    _REC.keep("counts", CountRecord(name, n, attrs, time.perf_counter_ns(),
                                    stack[-1] if stack else None))


def _within(t_ns: int, t0: Optional[float], t1: Optional[float]) -> bool:
    return (t0 is None or t_ns >= t0 * 1e9) and (t1 is None or t_ns <= t1 * 1e9)


def spans(t0: Optional[float] = None, t1: Optional[float] = None) -> List[SpanRecord]:
    """The kept spans whose host interval lies within ``[t0, t1]``, seconds
    on the ``time.perf_counter`` clock (None: unbounded), in closing order."""
    with _REC.lock:
        kept = list(_REC.spans)
    return [r for r in kept if _within(r.t0_ns, t0, None) and _within(r.t1_ns, None, t1)]


def host_ms(name: str, t0: Optional[float] = None, t1: Optional[float] = None) -> float:
    """Host milliseconds of the spans named ``name`` within ``[t0, t1]``."""
    return sum(r.t1_ns - r.t0_ns for r in spans(t0, t1) if r.name == name) / 1e6


def device_ms(name: str, t0: Optional[float] = None,
              t1: Optional[float] = None) -> Optional[float]:
    """Device milliseconds of the spans named ``name`` within ``[t0, t1]``:
    the sum of each one's timing events' ``elapsed_time``, after waiting on
    its end event (a sync: call it after the work it reads). None when no
    such span carries events (a host-only span, a CPU run)."""
    timed = [r.events for r in spans(t0, t1) if r.name == name and r.events is not None]
    if not timed:
        return None
    total = 0.0
    for start, end in timed:
        end.synchronize()
        total += start.elapsed_time(end)
    return total


def counts(name: str, t0: Optional[float] = None, t1: Optional[float] = None) -> int:
    """The sum of the counts named ``name`` made within ``[t0, t1]``."""
    with _REC.lock:
        kept = list(_REC.counts)
    return sum(c.n for c in kept if c.name == name and _within(c.t_ns, t0, t1))


def clock_anchor() -> Tuple[int, int]:
    """``(perf_counter_ns, time_ns)`` read together. ``torch.profiler``
    stamps its events (kineto's ``start_ns()``) with the wall clock, which
    ``time.time_ns()`` reads: on a CPU run the two agreed within 0.3 ms,
    while ``perf_counter_ns`` is years away from both. So a span's wall time,
    where it sits on a device trace, is ``t0_ns - anchor[0] + anchor[1]``."""
    a = time.perf_counter_ns()
    wall = time.time_ns()
    b = time.perf_counter_ns()
    return (a + b) // 2, wall


# a capture's length is bounded: the request's thread waits for it
MAX_CAPTURE_MS = 60_000
# trace.json categories of device activity (kernels, copies, fills)
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def capture(log_dir: str, duration_ms: float) -> Dict[str, object]:
    """Profile every thread of the process for ``duration_ms`` and write the
    trace to ``log_dir/trace.json``; the path and its counts of CPU ops and
    device events."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities,
                 experimental_config=_ExperimentalConfig(profile_all_threads=True)) as prof:
        time.sleep(duration_ms / 1e3)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    return {"path": path,
            "cpu_events": sum(e.get("cat") == "cpu_op" for e in events),
            "device_events": sum(e.get("cat") in DEVICE_CATEGORIES for e in events)}


class ProfilerServer:
    """The running capture endpoint: ``port``, ``log_dir`` (fixed at start; a
    request never names a path) and :meth:`stop`."""

    def __init__(self, port: int, log_dir: str):
        self.log_dir = log_dir
        self._captures = 0
        server = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                url = urllib.parse.urlparse(self.path)
                if url.path != "/capture":
                    return self._answer(404, {"error": "GET /capture?duration_ms=N"})
                try:
                    ms = float(urllib.parse.parse_qs(url.query)["duration_ms"][0])
                    if not 0 < ms <= MAX_CAPTURE_MS:
                        raise ValueError
                except (KeyError, ValueError):
                    return self._answer(400, {"error": "duration_ms must be in "
                                                       f"(0, {MAX_CAPTURE_MS}]"})
                server._captures += 1
                out = os.path.join(server.log_dir, f"capture_{server._captures}")
                try:
                    body = capture(out, ms)
                except Exception as e:      # the server outlives a failed capture
                    return self._answer(500, {"error": f"{type(e).__name__}: {e}"})
                self._answer(200, body)

            def _answer(self, code, body):
                data = json.dumps(body).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def log_message(self, *args):
                pass

        # one request at a time: a capture holds the profiler
        self._http = http.server.HTTPServer(("127.0.0.1", port), Handler)
        self.port = self._http.server_address[1]
        self._thread = threading.Thread(target=self._http.serve_forever,
                                        name="profiler-server", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Stop serving and free the port."""
        global _SERVER
        self._http.shutdown()
        self._http.server_close()
        self._thread.join()
        if _SERVER is self:
            _SERVER = None


_SERVER: Optional[ProfilerServer] = None


def start_server(port: int = 9999, log_dir: Optional[str] = None) -> ProfilerServer:
    """Start the capture endpoint on 127.0.0.1:``port`` (0: a free port) with
    its traces under ``log_dir`` (default: a new temporary directory). One runs
    at a time: a second start raises, as ``jax.profiler.start_server`` does."""
    global _SERVER
    if _SERVER is not None:
        raise RuntimeError(f"a profiler server is already running on port {_SERVER.port}")
    _SERVER = ProfilerServer(port, log_dir or tempfile.mkdtemp(prefix="vaegan_profile_"))
    return _SERVER


def stop_server() -> None:
    """Stop the running capture endpoint (``jax.profiler.stop_server``)."""
    if _SERVER is None:
        raise RuntimeError("no profiler server is running")
    _SERVER.stop()


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
