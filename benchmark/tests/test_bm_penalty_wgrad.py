"""The reader of the gradient penalty's weight gradients per step
(``penalty_wgrad_per_step.train``, from ``count("conv.penalty_wgrad")``), on
runs of the tiny cells that the program recorded on the CPU."""

import time

from test_bm_program_spans import _read, _run, profiling  # noqa: F401  (fixture)

NAME = "penalty_wgrad_per_step.train"


def test_penalty_wgrad_reader(bench, profiling, monkeypatch):
    """One penalty weight gradient a step for each of the tiny critic's
    convolutions (its first stage keeps its width, so has no shortcut): conv1
    and 2 + 3 + 3 in the blocks. A program without the counter reads nothing."""
    run = _run("notebook.train_b16", bench, profiling)
    assert _read(NAME, run) == 9.0
    assert _read(NAME, _run("notebook.recon_b64", bench, profiling)) is None
    count = profiling.count
    monkeypatch.setattr(profiling, "count", lambda name, *a, **k: (
        None if name == "conv.penalty_wgrad" else count(name, *a, **k)))
    run = _run("notebook.train_b16", bench, profiling)
    assert _read("host_syncs_per_step.train", run) == 1.0
    assert _read(NAME, run) is None


def test_nothing_to_read_reads_as_nothing(profiling, monkeypatch):
    """An untraced run, and an older program without the recorder, leave the
    metric out."""
    from harness.drivers import common
    from harness import trace
    run = common.Run(kind="train_loop", dtype="float32", batch=4, ops=3,
                     extra={"t0": 0.0, "t1": time.perf_counter()})
    assert _read(NAME, run) is None
    run.trace = trace.Trace(busy_s=1.0, window_s=1.0)
    monkeypatch.delattr(profiling, "device_ms")
    assert _read(NAME, run) is None
