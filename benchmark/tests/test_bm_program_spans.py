"""The readers of the program's own spans and counters (``harness/program_spans.py``
and the eight metrics that use it), on runs of the tiny cells whose spans the
program recorded on the CPU, with timing events that read the host clock in
place of a card's."""

import statistics
import time

import pytest

from conftest import tiny

TRAIN = ["g_forward_device_ms.train", "d_forward_device_ms.train",
         "d_backward_device_ms.train", "g_half_device_ms.train", "update_device_ms.train"]
LOOP = ["flush_wait_ms.train", "host_syncs_per_step.train"]
RECON = ["recon_device_ms.recon"]


class HostEvent:
    """A timing event on the host clock."""

    def record(self, stream=None):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


@pytest.fixture
def profiling(monkeypatch):
    from vaegan_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "_stream", lambda device: None if device is False else "s")
    monkeypatch.setattr(profiling, "_timing_event", HostEvent)
    profiling.clear()
    yield profiling
    profiling.clear()


def _run(name, bench, profiling):
    """A window of the tiny cell ``name`` with the program recording, read as
    a traced run."""
    from harness import spec, trace
    cell = tiny(spec.find_cell(name, bench))
    drv = spec.driver(cell.traffic["kind"]).Driver(cell, 2**31 + 11, "cpu")
    drv.setup()
    with profiling.tracing():
        run = drv.window(1.0)
    run.trace = trace.Trace(busy_s=run.window_s, window_s=run.window_s)
    return run


def _read(name, run):
    from harness import spec
    return spec.metric_reader(name)(run)


def test_training_readers(bench, profiling):
    run = _run("notebook.train_b16", bench, profiling)
    assert run.ops >= 1
    t0, t1 = run.extra["t0"], run.extra["t1"]
    got = {n: _read(n, run) for n in TRAIN + LOOP}
    assert got["g_forward_device_ms.train"] == pytest.approx(
        profiling.device_ms("step.g_forward", t0, t1) / run.ops)
    assert got["update_device_ms.train"] == pytest.approx(sum(
        profiling.device_ms(n, t0, t1) for n in ("step.reduce", "step.d_update",
                                                 "step.g_update", "step.ema")) / run.ops)
    assert all(got[n] > 0 for n in TRAIN)
    # the phases tile the step: their sum is at most the window's share of a step
    assert sum(got[n] for n in TRAIN) <= 1e3 * run.window_s / run.ops
    assert got["host_syncs_per_step.train"] == 1.0
    assert 0 < got["flush_wait_ms.train"] <= _read("loop_host_ms_per_step.train", run)
    assert _read("recon_device_ms.recon", run) is None


def test_serving_reader(bench, profiling):
    run = _run("notebook.recon_b64", bench, profiling)
    got = _read("recon_device_ms.recon", run)
    # each call's span lies inside its timed latency
    assert 0 < got <= 1e3 * statistics.fmean(run.latencies)
    assert all(_read(n, run) is None for n in TRAIN + LOOP)


@pytest.mark.parametrize("name", TRAIN + LOOP + RECON)
def test_nothing_to_read_reads_as_nothing(name, bench, profiling, monkeypatch):
    """An untraced run, and an older program without the recorder, leave the
    metric out."""
    from harness.drivers import common
    from harness import trace
    kind = "reconstruct" if name in RECON else "train_loop"
    run = common.Run(kind=kind, dtype="float32", batch=4, ops=3,
                     extra={"t0": 0.0, "t1": time.perf_counter()})
    assert _read(name, run) is None
    run.trace = trace.Trace(busy_s=1.0, window_s=1.0)
    monkeypatch.delattr(profiling, "device_ms")
    assert _read(name, run) is None
