"""The device trace's reduction: overlapping kernels count once, gaps carry
the host's span, and an empty or short trace fails instead of reading idle."""

import time

import pytest

from conftest import tiny

W = 1_000_000_000   # a one-second window, in ns


def _events(dev, host=()):
    return ([("bench.window", False, True, 0, W)]
            + [(n, True, False, s, e) for n, s, e in dev]
            + [(f"bench.{n}", False, True, s, e) for n, s, e in host])


def test_busy_is_the_union(monkeypatch):
    from harness import trace
    ev = _events([("k1", 0, 400_000_000), ("k2", 100_000_000, 500_000_000),
                  ("k1", 700_000_000, 950_000_000)],
                 [("step", 0, 600_000_000), ("feed", 500_000_000, 650_000_000)])
    monkeypatch.setattr(trace, "_events", lambda prof: ev)
    t = trace.reduce(None, "loop")
    assert t.busy_s == pytest.approx(0.75) and t.window_s == pytest.approx(1.0)
    assert t.idle_share == pytest.approx(0.25)
    assert t.gaps[0] == ("feed", pytest.approx(0.2)) and t.gaps[1] == ("loop", pytest.approx(0.05))
    assert t.kernels["k1"] == [pytest.approx(0.65), 2]


@pytest.mark.parametrize("dev", [[], [("k", 0, 500_000_000)]], ids=["empty", "stops_early"])
def test_short_trace_fails(monkeypatch, dev):
    from harness import trace
    monkeypatch.setattr(trace, "_events", lambda prof: _events(dev))
    with pytest.raises(trace.TraceShort):
        trace.reduce(None, "loop")


def test_traced_run_without_device_events_fails(bench):
    import run
    from harness import spec, trace
    cell = tiny(spec.find_cell("notebook.recon_b64", bench))
    with pytest.raises(trace.TraceShort):
        run.measure(cell, 5, 0.3, True, "cpu", time.perf_counter())
