"""The cell ``vaegan_paper.train_b16`` (CPU, tiny sizes): its pieces are found
by name, its driver runs Algorithm 1 through ``train()`` and reports a
training-loop run, its reference refuses another step, its operation count
holds the critic's three forwards, its comparison passes the program and fails
the control and the faults, and its five readers read the program's spans and
counter."""

import time

import pytest

from conftest import tiny

CELL = "vaegan_paper.train_b16"
NEW = ["prior_decode_device_ms.train", "grad_enc_device_ms.train",
       "grad_dec_device_ms.train", "grad_dis_device_ms.train"]
COUNTER = "critic_fused_bn_per_step.train"


def tiny_paper(bench):
    from harness import spec
    c = tiny(spec.find_cell(CELL, bench))
    c.traffic = dict(c.traffic, images=48, batch=4)
    return c


def full_config(bench):
    from harness import spec
    return spec.find_cell(CELL, bench).config["config"]


def _measure(cell, fault=None, seed=2 ** 31 + 5):
    import run
    return run.measure(cell, seed, 0.3, False, "cpu", time.perf_counter(), fault=fault)


def test_the_cell_is_found_with_its_metrics(bench):
    from harness import spec
    cell = spec.find_cell(CELL, bench)
    per_layer = {m["name"] for m in cell.per_layer}
    assert set(NEW + [COUNTER, "mfu.train", "fused_roofline.train",
                      "d_backward_device_ms.train"]) <= per_layer
    assert not any(n.startswith(("g_half", "penalty_wgrad")) for n in per_layer)
    assert {m["name"] for m in cell.end_to_end} == {"train_images_per_s", "setup_s"}
    assert cell.traffic["kind"] == "paper_loop" and cell.chips == 1
    assert cell.config["config"]["optim"]["scheme"] == "three"
    assert cell.config["reduced"] == []
    assert set(cell.limits) >= {"feed_gap", "loss_gap", "grad_gap_median", "change_gap",
                                "change_gap_median", "state_gap_median", "ema_gap"}


def test_the_driver_reports_a_training_loop_run(bench):
    from harness import spec
    cell = tiny_paper(bench)
    drv = spec.driver(cell.traffic["kind"]).Driver(cell, 7, "cpu")
    assert drv.run.kind == "train_loop"


def test_the_reference_refuses_the_two_optimizer_step(bench):
    import torch
    from harness import spec
    from reference import paper as rp
    from reference import train as rt
    cfg = spec.find_cell("notebook.train_b16", bench).config["config"]
    with pytest.raises(ValueError, match="Algorithm 1"):
        rp.step(cfg, rt.State({}, {}, {}, {}), torch.zeros((1, 8, 8, 1)), 0)


def test_the_operation_count_holds_three_critic_forwards(bench):
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from reference import model as rm
    from reference import paper as rp
    cfg = full_config(bench)
    batch, size = 16, cfg["data"]["image_size"]
    flops = rp.step_flops(cfg, batch)
    dp = {n: torch.empty(s, device="meta") for n, s, k in rm.critic_spec(cfg) if rm.is_param(k)}
    db = {n: torch.empty(s, device="meta") for n, s, k in rm.critic_spec(cfg)
          if not rm.is_param(k)}
    x = torch.empty((batch, size, size, 1), device="meta")
    with FlopCounterMode(display=False) as fc:
        rp.critic(cfg, rm.Net(dp, db), x, None)
    one_forward = fc.get_total_flops()
    # three forwards, and each one's backward in at least one pass
    assert flops > 0 and flops >= 3 * one_forward * 2


def test_program_passes(bench):
    assert _measure(tiny_paper(bench))["correct"]


def test_control_fails(bench):
    import calibrate
    from harness import compare
    cell = tiny_paper(bench)
    assert not compare.passed(compare.verdict(calibrate.control(cell, 11, "cpu"), cell.limits))


@pytest.mark.parametrize("fault", ["unchanged", "half", "lr2"])
def test_faults_fail(fault, bench):
    assert not _measure(tiny_paper(bench), fault)["correct"]


class HostEvent:
    """A timing event on the host clock."""

    def record(self, stream=None):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_the_new_readers_read_the_programs_spans(bench, monkeypatch):
    from harness import spec, trace
    from vaegan_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "_stream", lambda device: None if device is False else "s")
    monkeypatch.setattr(profiling, "_timing_event", HostEvent)
    profiling.clear()
    cell = tiny_paper(bench)
    drv = spec.driver(cell.traffic["kind"]).Driver(cell, 2 ** 31 + 11, "cpu")
    drv.setup()
    with profiling.tracing():
        run = drv.window(1.0)
    run.trace = trace.Trace(busy_s=run.window_s, window_s=run.window_s)
    try:
        got = {n: spec.metric_reader(n)(run) for n in NEW + [COUNTER]}
        whole = {n: spec.metric_reader(n)(run) for n in ("g_forward_device_ms.train",
                                                        "d_backward_device_ms.train")}
    finally:
        profiling.clear()
    assert run.ops >= 1
    assert all(got[n] > 0 for n in NEW)
    assert got["prior_decode_device_ms.train"] < whole["g_forward_device_ms.train"]
    passes = sum(got[n] for n in NEW[1:])
    assert passes <= whole["d_backward_device_ms.train"]
    assert passes >= 0.9 * whole["d_backward_device_ms.train"]
    assert got[COUNTER] == 21.0
    assert spec.metric_reader("g_half_device_ms.train")(run) is None


@pytest.mark.parametrize("name", NEW + [COUNTER])
def test_nothing_to_read_reads_as_nothing(name, monkeypatch):
    from harness import spec, trace
    from harness.drivers import common
    from vaegan_tpu_torch.utils import profiling
    run = common.Run(kind="train_loop", dtype="float32", batch=4, ops=3,
                     extra={"t0": 0.0, "t1": time.perf_counter()})
    assert spec.metric_reader(name)(run) is None
    run.trace = trace.Trace(busy_s=1.0, window_s=1.0)
    profiling.clear()
    assert spec.metric_reader(name)(run) is None
    monkeypatch.delattr(profiling, "device_ms")
    assert spec.metric_reader(name)(run) is None
