"""The last line of a run meets the contract, and a run's inputs and draws
are a function of its seed."""

import json
import math
import time

import pytest

from conftest import tiny

CELLS = ["notebook.train_b16", "vaegan_256_dp.train_b16", "notebook.recon_b64"]


@pytest.mark.parametrize("name", CELLS)
def test_result_line(name, bench):
    import run
    from harness import spec
    cell = tiny(spec.find_cell(name, bench))
    line = run.measure(cell, 2 ** 31 + 17, 0.5, False, "cpu", time.perf_counter())
    line = json.loads(json.dumps(line))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool) and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    for k, m in line["metrics"].items():
        assert m["unit"] == units[k] and math.isfinite(m["value"]) and m["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["checks"]) == set(cell.limits)
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and math.isfinite(c["value"])


def test_inputs_follow_the_seed():
    import torch
    from harness import inputs
    from reference import model as rm
    from vaegan_tpu_torch.config import preset
    spec_ = rm.critic_spec(preset("notebook").replace(
        data=preset("notebook").data.replace(image_size=16)).to_dict())
    a = inputs.make_weights(spec_, 2 ** 33 + 1, "cpu", "critic")[0]
    b = inputs.make_weights(spec_, 2 ** 33 + 1, "cpu", "critic")[0]
    c = inputs.make_weights(spec_, 2 ** 33 + 2, "cpu", "critic")[0]
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["linear_1.weight"], c["linear_1.weight"])
    assert torch.equal(inputs.make_images(4, 16, 5, "cpu"), inputs.make_images(4, 16, 5, "cpu"))
