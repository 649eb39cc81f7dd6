"""The port's spans and counters (``vaegan_tpu_torch.utils.profiling``), on the
CPU at 16² with a tiny config: off they record nothing and call nothing; under
``torch.profiler`` the loop's, the step's and the flush's spans nest in the
trace in event order and carry their step; the metric flush is the one host
sync of a plain step; a span's host start lands on the profiler's clock through
``clock_anchor``; the rings drop the oldest; ``reconstruct`` numbers its calls;
``device_ms`` reads a span's timing events; Algorithm 1's step spans its prior
decode and each group's gradient pass, and the fused critic counts its BN +
LeakyReLU chains."""

from __future__ import annotations

import time
from pathlib import Path

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import vaegan_tpu_torch as vt
from vaegan_tpu_torch import inference
from vaegan_tpu_torch.config import DiscriminatorConfig, GeneratorConfig
from vaegan_tpu_torch.train.state import create_generator_state
from vaegan_tpu_torch.utils import profiling
from vaegan_tpu_torch.utils.metrics import MetricsLogger

torch.set_num_threads(1)

# a two-optimizer step's spans in event order (every step updates G here)
PHASES = ["step.g_forward", "step.d_forward", "step.d_backward", "step.reduce",
          "step.d_update", "step.g_half", "step.reduce", "step.g_update", "step.ema",
          "step.reduce"]


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.disable()
    profiling.clear()
    yield
    profiling.disable()
    profiling.clear()


def tiny_cfg(tmp_path: Path, **train_kw) -> vt.Config:
    base = vt.Config()
    return base.replace(
        generator=GeneratorConfig(depth=1, length=1, feature_size=8),
        discriminator=DiscriminatorConfig(
            num_stride_conv1=1, num_features_conv1=8, num_blocks=(1,), num_strides_res=(2,),
            num_features_res=(16,), pool_size=2, linear_widths=(16, 8, 8)),
        data=base.data.replace(image_size=16, batch_size=4, synthetic=True, synthetic_size=16,
                               hbm_cache=True),
        train=base.train.replace(**{"n_epochs": 1, "max_steps": 2, "sample_interval": 0,
                                    "log_every": 1, "use_pallas": "all",
                                    "sample_dir": str(tmp_path / "samples"), **train_kw}))


def run(cfg):
    return vt.train(cfg, device="cpu", logger=MetricsLogger(sinks=[]))


def ancestors(rec):
    out = []
    while rec is not None:
        out.append(rec.name)
        rec = rec.parent
    return out


def test_off_records_nothing_and_calls_nothing(tmp_path, monkeypatch):
    """No profiler and no ``tracing()``: a two-step run opens no
    ``record_function``, makes no timing event, keeps no span and no count."""
    def refuse(*a, **k):
        raise AssertionError("a span did more than its flag check")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(profiling, "_stream", refuse)
    monkeypatch.setattr(profiling, "_timing_event", refuse)
    _, logger = run(tiny_cfg(tmp_path))
    assert len([m for m in logger.history if "_wall_s" not in m]) == 2
    assert profiling.spans() == [] and profiling.counts("host_sync") == 0
    with profiling.span("step.d_backward", device=torch.device("cuda"), step=7):
        pass
    profiling.count("host_sync", where="metrics")
    assert profiling.spans() == [] and profiling.counts("host_sync") == 0


def test_profiler_trace_nests_loop_step_and_phases(tmp_path):
    """Under ``torch.profiler``: each ``vaegan.step`` sits inside a
    ``vaegan.loop.step`` and holds the step's phases in event order; the
    in-memory records carry ``step=`` 0 and 1, the phases their loop's."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(tiny_cfg(tmp_path))
    ev = sorted((e.time_range.start, -e.time_range.end, e.name) for e in prof.events()
                if e.name.startswith(profiling.PREFIX) and e.device_type == DeviceType.CPU)
    steps = [(s, -e) for s, e, n in ev if n == "vaegan.step"]
    loops = [(s, -e) for s, e, n in ev if n == "vaegan.loop.step"]
    assert len(steps) == 2
    for s0, s1 in steps:
        assert any(a <= s0 and s1 <= b for a, b in loops)
        inner = [n for s, e, n in ev if s0 <= s and -e <= s1 and n.startswith("vaegan.step.")]
        assert inner == [profiling.PREFIX + p for p in PHASES]
    names = {n for _, _, n in ev}
    assert {"vaegan.loop.feed", "vaegan.metrics.flush", "vaegan.metrics.copy",
            "vaegan.feed.epoch", "vaegan.feed.gather"} <= names

    recs = profiling.spans()
    assert [r.attrs["step"] for r in recs if r.name == "step"] == [0, 1]
    for r in recs:
        if r.name.startswith("step."):
            assert ancestors(r)[1:] == ["step", "loop.step"]
            assert r.attrs == {"step": r.parent.attrs["step"]}
    assert [r.name for r in recs if r.name.startswith("step.")] == PHASES * 2


@pytest.mark.parametrize("nan_check", [False, True], ids=["plain", "nan_guard"])
def test_the_flush_is_the_one_host_sync_a_step(tmp_path, nan_check):
    """``log_every=1`` with no grid and no checkpoint: one ``host_sync`` a
    step, made in ``metrics.copy`` inside ``metrics.flush`` of that step (the
    NaN guard's flush then finds the buffer already flushed)."""
    with profiling.tracing():
        run(tiny_cfg(tmp_path, max_steps=3, nan_check=nan_check))
    assert profiling.counts("host_sync") == 3
    with profiling._REC.lock:
        kept = [c for c in profiling._REC.counts if c.name == "host_sync"]
    assert [c.attrs for c in kept] == [{"where": "metrics"}] * 3
    assert [ancestors(c.span)[:2] for c in kept] == [["metrics.copy", "metrics.flush"]] * 3
    assert [c.span.attrs["step"] for c in kept] == [0, 1, 2]
    copies = [r for r in profiling.spans() if r.name == "metrics.copy"]
    assert profiling.host_ms("metrics.copy") == pytest.approx(
        sum(r.t1_ns - r.t0_ns for r in copies) / 1e6)


def test_a_loop_step_that_runs_no_step_carries_no_step_id(tmp_path):
    """Two epochs of two steps: each epoch ends in a ``loop.step`` whose one
    ``loop.feed`` finds it done; those two carry ``step=None`` (their feed
    too), so the steps' ids are 0-3, once each."""
    cfg = tiny_cfg(tmp_path, n_epochs=2, max_steps=None)
    cfg = cfg.replace(data=cfg.data.replace(synthetic_size=8))
    with profiling.tracing():
        run(cfg)
    recs = profiling.spans()
    loops = [r.attrs["step"] for r in recs if r.name == "loop.step"]
    assert loops == [0, 1, None, 2, 3, None]
    assert [r.attrs["step"] for r in recs if r.name == "loop.feed"] == loops
    assert [r.attrs["step"] for r in recs if r.name == "step"] == [0, 1, 2, 3]


def test_grids_and_checkpoints_count_their_syncs(tmp_path):
    """A grid every step and a checkpoint every step: each writes once a step
    and counts once; the closing save finds its step written and counts
    nothing."""
    cfg = tiny_cfg(tmp_path, sample_interval=1, checkpoint_every=1,
                   checkpoint_dir=str(tmp_path / "ckpt"))
    with profiling.tracing():
        run(cfg)
    with profiling._REC.lock:
        wheres = [c.attrs["where"] for c in profiling._REC.counts if c.name == "host_sync"]
    assert wheres == ["metrics", "grid", "checkpoint"] * 2
    names = [r.name for r in profiling.spans()]
    assert names.count("loop.sample") == 2 and names.count("loop.grid") == 2
    assert names.count("loop.checkpoint") == 3


def test_clock_anchor_places_a_span_on_the_profiler_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        anchor = profiling.clock_anchor()
        with profiling.span("anchor.check"):
            torch.ones(64).sum()
    rec = next(r for r in profiling.spans() if r.name == "anchor.check")
    starts = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name() == profiling.PREFIX + "anchor.check"]
    assert len(starts) == 1
    assert abs(rec.t0_ns - anchor[0] + anchor[1] - starts[0]) < 1_000_000


def test_rings_drop_the_oldest_and_count_them(monkeypatch):
    monkeypatch.setattr(profiling, "CAPACITY", 4)
    profiling.clear()
    with profiling.tracing():
        for i in range(10):
            with profiling.span("ring", i=i):
                profiling.count("ticks", n=2)
    assert [r.attrs["i"] for r in profiling.spans()] == [6, 7, 8, 9]
    assert profiling.counts("ticks") == 8
    assert profiling.dropped() == {"spans": 6, "counts": 6}


def test_reconstruct_numbers_its_calls(tmp_path):
    cfg = tiny_cfg(tmp_path)
    state = create_generator_state(cfg, device="cpu")
    batch = torch.rand(2, 16, 16, 1)
    inference.reconstruct(cfg, state, batch)            # off: not recorded
    with profiling.tracing():
        for _ in range(3):
            inference.reconstruct(cfg, state, batch)
    recs = profiling.spans()
    assert [r.name for r in recs] == ["serve.reconstruct"] * 3
    calls = [r.attrs["call"] for r in recs]
    assert calls == list(range(calls[0], calls[0] + 3)) and calls[0] >= 1
    assert profiling.device_ms("serve.reconstruct") is None     # no card: no device time


class FakeEvent:
    """A timing event on the host clock, for a run without a card."""

    def __init__(self):
        self.t = None
        self.waited = False

    def record(self, stream=None):
        self.t = time.perf_counter()

    def synchronize(self):
        self.waited = True

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_device_ms_reads_each_spans_events_within_the_window(monkeypatch):
    made = []
    monkeypatch.setattr(profiling, "_stream", lambda device: None if device is False else "s")
    monkeypatch.setattr(profiling, "_timing_event", lambda: made.append(FakeEvent()) or made[-1])
    with profiling.tracing():
        with profiling.span("phase", device=torch.device("cuda")):
            time.sleep(0.01)
        t0 = time.perf_counter()
        for _ in range(2):
            with profiling.span("phase", device=torch.device("cuda")), profiling.span("host"):
                time.sleep(0.005)
        t1 = time.perf_counter()
    assert len(made) == 6 and not any(e.waited for e in made)
    inside = [r for r in profiling.spans(t0, t1) if r.name == "phase"]
    assert len(inside) == 2
    want = sum(r.events[0].elapsed_time(r.events[1]) for r in inside)
    assert profiling.device_ms("phase", t0, t1) == pytest.approx(want)
    assert all(e.waited for r in inside for e in r.events[1:])
    assert profiling.device_ms("phase") > profiling.device_ms("phase", t0, t1) >= 10.0
    assert profiling.device_ms("host", t0, t1) is None
    assert profiling.host_ms("host", t0, t1) >= 10.0


def paper_cfg(tmp_path: Path, **train_kw) -> vt.Config:
    """The ``vaegan_paper`` preset at 16² with the notebook critic's block
    structure (a stem and three blocks, so seven BN + LeakyReLU chains a
    forward) at narrow widths."""
    base = vt.preset("vaegan_paper")
    tiny = tiny_cfg(tmp_path, **train_kw)
    return base.replace(
        generator=tiny.generator,
        discriminator=base.discriminator.replace(
            num_features_conv1=8, num_blocks=(1, 1, 1), num_strides_res=(1, 2, 2),
            num_features_res=(8, 16, 16), pool_size=2, linear_widths=(16, 8)),
        data=tiny.data, train=tiny.train.replace(ema_decay=0.999))


PAPER_GRADS = ["step.grad_enc", "step.grad_dec", "step.grad_dis"]


@pytest.mark.parametrize("grad_accum", [1, 2], ids=["one_batch", "accumulated"])
def test_the_paper_step_spans_its_prior_decode_and_each_gradient_pass(tmp_path, grad_accum):
    """Algorithm 1's step: ``step.prior_decode`` inside ``step.g_forward``,
    and the three groups' passes inside ``step.d_backward``, encoder, decoder,
    critic, once a (micro)batch."""
    cfg = paper_cfg(tmp_path, max_steps=1, grad_accum=grad_accum)
    with profiling.tracing():
        run(cfg)
    recs = [r for r in profiling.spans() if r.name.startswith("step.")]
    decodes = [r for r in recs if r.name == "step.prior_decode"]
    passes = [r for r in recs if r.name in PAPER_GRADS]
    assert len(decodes) == grad_accum
    assert all(ancestors(r)[1:4] == ["step.g_forward", "step", "loop.step"] for r in decodes)
    assert [r.name for r in passes] == PAPER_GRADS * grad_accum
    assert all(ancestors(r)[1:4] == ["step.d_backward", "step", "loop.step"] for r in passes)
    for r in passes:       # in turn, each inside its own d_backward
        assert r.parent.t0_ns <= r.t0_ns <= r.t1_ns <= r.parent.t1_ns
    assert [r.t0_ns for r in passes] == sorted(r.t0_ns for r in passes)


def test_the_fused_critic_counts_each_bn_act_chain(tmp_path):
    """With ``use_pallas="all"`` and no penalty the critic runs its stem's
    and each block's two BN + LeakyReLU chains through row 1: 7 a forward,
    21 an Algorithm-1 step (three forwards); under the notebook's WGAN-GP
    step the critic is unfused and counts none."""
    cfg = paper_cfg(tmp_path, max_steps=1)
    state = vt.create_train_state(cfg, device="cpu")
    assert state.critic.use_pallas
    with profiling.tracing():
        state.critic(torch.rand(2, 16, 16, 1), train=True)
    assert profiling.counts("critic.fused_bn_act") == 7
    profiling.clear()
    with profiling.tracing():
        run(cfg)
    assert profiling.counts("critic.fused_bn_act") == 21
    profiling.clear()
    with profiling.tracing():
        run(tiny_cfg(tmp_path, max_steps=1))
    assert profiling.counts("critic.fused_bn_act") == 0
