"""Metrics: kept on the device, flushed to the host in one transfer, pluggable
sinks (port of ``vaegan_tpu/utils/metrics.py``).

The reference synchronizes the device seven times per batch (``.item()`` in its
print). Here a step's metric dict stays on the device (0-d tensors) and
:class:`MetricsLogger` moves the buffered values to the host every
``flush_every`` steps with ONE copy: the scalars are stacked on the device and
the stack is copied once, never a ``float()`` per value.

The sinks keep the reference's Neptune channel names: "D loss", "G loss", "Recon
loss", "KL", "D Real loss", "D Fake loss", "adversarial loss".
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, List, Mapping, Optional, TextIO

import torch

from vaegan_tpu_torch.utils.profiling import count, span

# our metric key -> reference Neptune channel name
REFERENCE_KEYS = {
    "d_loss": "D loss",
    "g_loss": "G loss",
    "recon_loss": "Recon loss",
    "kl": "KL",
    "d_real_loss": "D Real loss",
    "d_fake_loss": "D Fake loss",
    "adv_loss": "adversarial loss",
}


class StdoutSink:
    """The reference's per-batch line, character for character."""

    def __init__(self, stream: Optional[TextIO] = None):
        self.stream = stream or sys.stdout

    def write(self, epoch: int, n_epochs: int, batch: int, n_batches: int,
              metrics: Mapping[str, float]) -> None:
        m = {k: round(float(v), 3) for k, v in metrics.items()}
        self.stream.write(
            f"[Epoch {epoch}/{n_epochs}] [Batch {batch}/{n_batches}] "
            f"[D loss: {m.get('d_loss')}] [G loss: {m.get('g_loss')}] "
            f"[Recon loss: {m.get('recon_loss')}] [KL: {m.get('kl')}], "
            f"[Real loss: {m.get('d_real_loss')}], [Fake loss: {m.get('d_fake_loss')}] "
            f"[adversarial loss: {m.get('adv_loss')}]]\n")
        self.stream.flush()


class JsonlSink:
    """One JSON object per flushed step; a machine-readable training curve."""

    def __init__(self, path: str):
        self.path = path
        self._f: Optional[TextIO] = None

    def write(self, epoch, n_epochs, batch, n_batches, metrics) -> None:
        if self._f is None:
            self._f = open(self.path, "a")
        rec = {"ts": time.time(), "epoch": epoch, "batch": batch}
        rec.update({REFERENCE_KEYS.get(k, k): float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        if self._f:
            self._f.close()
            self._f = None


class NeptuneSink:
    """Streams the reference's Neptune channels to a ``neptune.init_run``-style
    object (``run[key].append(value)``); the run object is injected."""

    def __init__(self, run):
        self.run = run

    def write(self, epoch, n_epochs, batch, n_batches, metrics) -> None:
        for key, channel in REFERENCE_KEYS.items():
            if key in metrics:
                self.run[channel].append(float(metrics[key]))

    def close(self):
        stop = getattr(self.run, "stop", None)
        if callable(stop):
            stop()


def to_host(dicts: List[Mapping[str, Any]]) -> List[Dict[str, float]]:
    """Metric dicts of 0-d tensors (and plain numbers) -> dicts of floats, with
    one device-to-host copy: every value is stacked on the first tensor's device
    and the stack is copied once."""
    keys = [(i, k) for i, m in enumerate(dicts) for k in m]
    if not keys:
        return [{} for _ in dicts]
    vals = [dicts[i][k] for i, k in keys]
    dev = next((v.device for v in vals if isinstance(v, torch.Tensor)), torch.device("cpu"))
    stacked = torch.stack([torch.as_tensor(v, device=dev).detach().reshape(()).float()
                           for v in vals])
    with span("metrics.copy"):
        count("host_sync", where="metrics")
        host = stacked.cpu().tolist()
    out: List[Dict[str, float]] = [{} for _ in dicts]
    for (i, k), v in zip(keys, host):
        out[i][k] = v
    return out


class MetricsLogger:
    """Buffers on-device metric dicts; flushes them to the sinks every
    ``flush_every`` steps.

    ``log`` keeps the tensors and does not sync; only ``flush`` copies to the
    host, once for the whole buffer (:func:`to_host`).
    """

    def __init__(self, sinks: Optional[List[Any]] = None, flush_every: int = 1):
        self.sinks = sinks if sinks is not None else [StdoutSink()]
        self.flush_every = max(1, flush_every)
        self._buf: List[tuple] = []
        self._count = 0
        self.last_flush_time = time.time()
        self.history: List[Dict[str, float]] = []

    def log(self, epoch: int, n_epochs: int, batch: int, n_batches: int,
            metrics: Mapping[str, torch.Tensor]) -> None:
        self._buf.append((epoch, n_epochs, batch, n_batches, metrics))
        self._count += 1
        if self._count % self.flush_every == 0:
            self.flush()

    def flush(self) -> None:
        if not self._buf:
            return
        with span("metrics.flush"):
            host = to_host([m for *_, m in self._buf])
            for (epoch, n_epochs, batch, n_batches, _), metrics in zip(self._buf, host):
                self.history.append(metrics)
                for sink in self.sinks:
                    sink.write(epoch, n_epochs, batch, n_batches, metrics)
            self._buf.clear()
        self.last_flush_time = time.time()

    def close(self):
        self.flush()
        for s in self.sinks:
            if hasattr(s, "close"):
                s.close()
