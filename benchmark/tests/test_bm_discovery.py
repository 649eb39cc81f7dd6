"""A configuration, a traffic mix, a cell and a metric are added as files and
entries, and are found without editing any file already there."""

import hashlib
import json
import shutil
import time

from conftest import BENCH, tiny


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in (root / "benchmark").rglob("*") if p.is_file()}


def test_added_files_are_found(tmp_path, bench):
    import run
    from harness import spec

    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("_work", "__pycache__", "tests"))
    before = _digests(root)

    small = tiny(spec.find_cell("notebook.train_b16", bench))
    (root / "benchmark/configs/small.json").write_text(json.dumps(small.config))
    (root / "benchmark/traffic/train_b2.json").write_text(
        json.dumps(dict(small.traffic, batch=2, images=16)))
    (root / "benchmark/limits/small.train_b2.json").write_text(
        json.dumps({"limits": {"feed_gap": 0.0}}))
    (root / "benchmark/metrics/steps_done.py").write_text(
        "def read(run):\n    return float(run.ops)\n")
    b = dict(bench)
    b["configs"] = bench["configs"] + [{"name": "small", "source": "a test",
                                        "file": "benchmark/configs/small.json", "reduced": [],
                                        "why": "a test"}]
    b["workloads"] = bench["workloads"] + [{"name": "small.train_b2", "config": "small",
                                            "traffic": "train_b2", "chips": 1, "why": "a test"}]
    b["end_to_end"] = bench["end_to_end"] + [{"name": "steps_done", "unit": "steps",
                                              "better": "higher", "bound": 0.01,
                                              "source": "host_clock",
                                              "workloads": ["small.train_b2"]}]
    (root / "BENCHMARK.json").write_text(json.dumps(b))

    cell = spec.find_cell("small.train_b2", spec.load_benchmark(root), root)
    assert cell.traffic["batch"] == 2 and cell.config["config"]["data"]["image_size"] == 16
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "steps_done"]
    line = run.measure(cell, 7, 0.5, False, "cpu", time.perf_counter(), root=root)
    assert line["metrics"]["steps_done"]["value"] == line["attempted"] > 0
    assert line["checks"] == {"feed_gap": {"value": 0.0, "limit": 0.0}}
    after = _digests(root)
    assert {k: v for k, v in after.items() if k in before} == before
