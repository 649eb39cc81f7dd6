"""Profiling and tracing (port of ``vaegan_tpu/utils/profiling.py``).

- ``trace(dir)``: context manager around ``torch.profiler.profile`` (host and,
  where there is a card, device activity) that writes a Chrome trace,
  ``<dir>/trace.json``, viewable in Perfetto or ``chrome://tracing``;
- ``annotate(name)``: a named range in that trace
  (``torch.profiler.record_function``);
- ``start_server(port, log_dir)`` / ``stop_server()``: a live capture endpoint,
  the counterpart of ``jax.profiler.start_server``: an HTTP server on
  127.0.0.1 whose ``GET /capture?duration_ms=N`` records ``torch.profiler``
  over the next N ms of whatever the process runs, on every thread (the CPU,
  and the card's kernels where there is one), writes
  ``<log_dir>/capture_<n>/trace.json`` and answers ``{"path", "cpu_events",
  "device_events"}`` as JSON;
- ``StepTimer``: steps/s and images/s with warmup excluded, synced by copying a
  metric tensor to the host.
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
