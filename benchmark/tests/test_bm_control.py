"""The comparison fails the lower-precision control and each fault a cell can
have; the program passes it (CPU, tiny sizes)."""

import time

import pytest

from conftest import tiny

TRAIN = ["notebook.train_b16", "vaegan_256_dp.train_b16"]


def _measure(cell, fault=None, seed=2 ** 31 + 3):
    import run
    return run.measure(cell, seed, 0.3, False, "cpu", time.perf_counter(), fault=fault)


def test_program_passes(bench):
    from harness import spec
    assert _measure(tiny(spec.find_cell("notebook.train_b16", bench)))["correct"]
    assert _measure(tiny(spec.find_cell("notebook.recon_b64", bench)))["correct"]


@pytest.mark.parametrize("name", TRAIN + ["notebook.recon_b64"])
def test_control_fails(name, bench):
    import calibrate
    from harness import compare, spec
    cell = tiny(spec.find_cell(name, bench))
    readings = calibrate.control(cell, 11, "cpu")
    assert not compare.passed(compare.verdict(readings, cell.limits))


@pytest.mark.parametrize("fault", ["unchanged", "half"])
@pytest.mark.parametrize("name", TRAIN)
def test_training_faults_fail(name, fault, bench):
    from harness import spec
    line = _measure(tiny(spec.find_cell(name, bench)), fault)
    assert not line["correct"]
    checks = line["checks"]
    if fault == "unchanged":       # by the measures, whatever the sizes
        if "change_gap" in checks:
            assert checks["change_gap"]["value"] == pytest.approx(1.0)
        if "grad_gap_median" in checks:
            assert checks["grad_gap_median"]["value"] >= 0.5
        if "change_gap_median" in checks:
            assert checks["change_gap_median"]["value"] >= 0.5


@pytest.mark.parametrize("name", TRAIN)
def test_twice_the_learning_rate_fails(name, bench):
    from harness import spec
    line = _measure(tiny(spec.find_cell(name, bench)), "lr2")
    assert not line["correct"]


def test_the_fp8_control_is_nowhere_finer_than_bfloat16():
    import torch
    from reference import model as rm
    from reference.precision import KINDS, round_bf16

    def on_bf16(t):
        return torch.equal(t, t.to(torch.bfloat16).float())

    x = torch.randn(5, 7, requires_grad=True)
    y = round_bf16(x)
    (g,) = torch.autograd.grad((y * torch.randn(5, 7)).sum(), x)
    assert on_bf16(y) and on_bf16(g)
    torch.manual_seed(0)
    p = {"c.weight": torch.randn(4, 3, 3, 3), "n.weight": torch.rand(4) + 0.5,
         "n.bias": torch.randn(4), "l.weight": torch.randn(2, 4), "l.bias": torch.randn(2)}
    b = {"n.running_mean": torch.zeros(4), "n.running_var": torch.ones(4)}
    net = rm.Net(p, b, KINDS["fp8"])
    h = net.conv(torch.randn(2, 3, 5, 5), p["c.weight"], 1, 1)
    n = net.bn(h, "n", True)
    out = net.linear(n.mean((2, 3)), "l")
    assert on_bf16(h) and on_bf16(n) and on_bf16(out)


def test_an_ema_left_unchanged_reads_one():
    import torch
    from harness import compare
    p0, p1 = {"w": torch.zeros(3)}, {"w": torch.tensor([1.0, -2.0, 0.5])}
    start, prog = {"ema": p0}, {"ema": p0, "gp": p1}
    assert compare._ema_gap(0.999, [start], [prog]) == pytest.approx(1.0)
    prog = {"ema": {"w": 0.001 * p1["w"]}, "gp": p1}
    assert compare._ema_gap(0.999, [start], [prog]) == pytest.approx(0.0, abs=1e-6)


@pytest.mark.parametrize("fault", ["half", "altered"])
def test_serving_faults_fail(fault, bench):
    from harness import spec
    assert not _measure(tiny(spec.find_cell("notebook.recon_b64", bench)), fault)["correct"]


@pytest.mark.card
@pytest.mark.parametrize("name", TRAIN + ["notebook.recon_b64"])
def test_control_fails_at_the_cells_size(name, bench, card):
    import calibrate
    from harness import compare, spec
    cell = spec.find_cell(name, bench)
    assert not compare.passed(compare.verdict(calibrate.control(cell, 2 ** 31 + 9, card),
                                              cell.limits))
