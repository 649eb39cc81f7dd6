"""Finding a cell's pieces by name: ``BENCHMARK.json`` at the checkout's root,
and under ``benchmark/`` one file per configuration (``configs/<name>.json``),
per traffic mix (``traffic/<name>.json``), per cell's limits
(``limits/<cell>.json``) and per metric (``metrics/<name>.py``). A traffic file
names its ``kind``, the driver that runs it (``harness/drivers/<kind>.py``).
Nothing here lists cells, configurations or metrics: adding one is adding
files and entries."""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict          # the configuration file: source, assumed, reduced, config
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return read_json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str, e2e_names) -> bool:
    wl = metric.get("workloads")
    if wl is not None:
        return cell in wl
    return metric.get("moves") in e2e_names


def find_cell(name: str, bench: dict, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its files read; its end-to-end metrics (those
    that list it, or list no cells) and its per-layer metrics (those that list
    it, or, listing none, move one of its end-to-end metrics)."""
    wl = {w["name"]: w for w in bench["workloads"]}
    if name not in wl:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = wl[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if m.get("workloads") is None or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    bench_dir = root / BENCH_DIR.name
    limits = read_json(bench_dir / "limits" / f"{name}.json")["limits"]
    return Cell(name=name, chips=int(w["chips"]), config=read_json(root / conf["file"]),
                traffic=read_json(bench_dir / "traffic" / f"{w['traffic']}.json"),
                limits=limits, end_to_end=e2e, per_layer=per_layer)


def driver(kind: str):
    """The driver module of a traffic kind."""
    return importlib.import_module(f"harness.drivers.{kind}")


def metric_reader(name: str, root: Path = ROOT):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = root / BENCH_DIR.name / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
