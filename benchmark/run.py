"""The benchmark of ``vaegan_tpu_torch`` on one card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs from the root of a checkout. It finds the cell in ``BENCHMARK.json``,
reads its configuration, traffic and limits files under ``benchmark/``, makes
its inputs and weights from ``--seed``, sets the program up and warms it (the
first steps of a training cell are also the steps it compares), measures for
``--seconds``, then frees the program and holds what the timed path produced
against the plain reference (``benchmark/reference``). The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
ones), ``device`` and, last, ``checks``: each compared number beside its limit,
which are also the last lines of standard error.

It refuses to run (exit 2) without CUDA or with fewer cards than the cell
asks for, and fails (exit 3) if JAX, flax or the JAX package ``vaegan_tpu`` has
been loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
WORK = BENCH / "_work"
FORBIDDEN = ("jax", "jaxlib", "flax", "vaegan_tpu")

# every build and kernel cache of a run at a fixed place inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(WORK / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(WORK / "triton")
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's (the port's name begins with the JAX package's, so the whole
    top-level name is compared)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def measure(cell, seed: int, seconds: float, traced: bool, device, t0: float,
            fault=None, root: Path = ROOT) -> dict:
    """One run of ``cell``; its result line as a dict."""
    import torch

    from harness import compare, spec
    from harness.drivers import common
    from harness.trace import power_limit

    cuda = torch.device(device).type == "cuda"
    drv = spec.driver(cell.traffic["kind"]).Driver(cell, seed, device, traced, fault)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    drv.setup_t0 = time.perf_counter()
    drv.setup()
    common.sync(device)
    run = drv.run
    run.setup_s = time.perf_counter() - t0
    drv.window(seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    drv.release()
    readings = drv.checks()
    checks = compare.verdict(readings, cell.limits)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = spec.metric_reader(m["name"], root)(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    line = {"correct": checks is not None and compare.passed(checks), "attempted": run.ops,
            "failed": 0, "metrics": metrics, "device": dev}
    if traced:
        dev.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        line["breakdown"] = {"device_ops": run.trace.device_ops(),
                             "idle_gaps": [list(g) for g in run.trace.gaps]}
        line["card"] = power_limit() if cuda else None
    line["setup_parts"] = {"start": drv.setup_t0 - t0, **run.extra.get("setup_parts", {})}
    line["details"] = readings.get("details")
    line["checks"] = checks if checks is not None else {
        k: {"value": readings.get(k, math.nan), "limit": v} for k, v in cell.limits.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from harness import spec

    cell = spec.find_cell(args.workload, spec.load_benchmark())
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, torch.get_num_threads()))
    line = measure(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 3
    for k, c in line["checks"].items():
        print(f"check {k} = {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
