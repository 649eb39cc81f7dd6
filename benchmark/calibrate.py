"""The readings that a cell's limits are set from, in one process on the card.

    python benchmark/calibrate.py --workload <cell> --seeds 12 --first-seed <n> \
        [--controls 3] [--faults 3] [--fault-kinds half,lr2] [--witnesses 3] \
        [--out file.jsonl]

- ``program``: the timed path's readings on each seed, as a run takes them
  (a training cell's compared steps come from set-up, so no window is run; a
  serving cell runs a short window at its own load, long enough for the
  sampled calls);
- ``control``: the reference itself in the program's place, computed in the
  nearest precision below the configuration's (TF32 below float32, fp8 below
  bfloat16), held to the float32 reference by the same comparison;
- ``fault``: the timed path broken underneath, as a run reads it: ``half``
  (half of each batch left out, the mean taken over the rest), ``lr2`` (both
  optimizers at twice their learning rate), ``altered`` (serving: a sampled
  reconstruction altered where it is produced);
- ``witness`` (bfloat16 only): the reference in the program's place at the
  configuration's own precision (``reference.precision``'s ``bf16``): what
  bfloat16 rounding alone reads, beside the program.

One JSON line per reading, then a summary: per number, the largest program
reading and the smallest control and fault readings.
"""

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def _drop(r: dict) -> dict:
    return {k: v for k, v in r.items() if k != "details"}


def program(cell, seed, device, fault=None, seconds=12.0):
    from harness import spec
    drv = spec.driver(cell.traffic["kind"]).Driver(cell, seed, device, False, fault)
    drv.setup()
    if cell.traffic["kind"] == "reconstruct":
        drv.window(seconds)
    drv.release()
    return drv.checks()


def control(cell, seed, device, kind=None):
    """The reference in the program's place, a precision lower (or ``kind``)."""
    from harness import compare, spec
    from harness.drivers import common
    from reference import serve as rs

    kind = kind or CONTROL[cell.config["config"]["train"]["dtype"]]
    drv = spec.driver(cell.traffic["kind"]).Driver(cell, seed, device)
    if cell.traffic["kind"] == "reconstruct":
        drv.images = drv.make_images()
        params, buffers = drv.weights()
        for i in sorted(drv.keep):
            recon, mse = rs.reconstruct(drv.cfg_dict, params, buffers, drv.batch(i), kind)
            drv.kept[i] = (recon.cpu(), mse)
        return drv.checks()
    images = drv.images()
    batches = drv.ref_batches(images, drv.compared)
    s = drv.start()
    start = {k: v if not isinstance(v, dict) else common.to_host(v) for k, v in s.items()}
    lowers, prev = [], start
    for k in range(drv.compared):
        r = drv.reference_steps([prev], [batches[k]], kind, first=k)[0]
        r["batch"] = batches[k].cpu()
        lowers.append(r)
        prev = r
    starts = [start] + lowers[:-1]
    refs = drv.reference_steps(starts, batches)
    return compare.train_checks(drv.cfg_dict, starts, lowers, refs, batches)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--faults", type=int, default=3)
    ap.add_argument("--fault-kinds", default="half")
    ap.add_argument("--witnesses", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    a = ap.parse_args(argv)
    from harness import spec
    cell = spec.find_cell(a.workload, spec.load_benchmark())
    rows = []
    jobs = ([("program", a.first_seed + i) for i in range(a.seeds)]
            + [("control", a.first_seed + 1000 + i) for i in range(a.controls)]
            + [(f"fault {f}", a.first_seed + 2000 + 100 * j + i)
               for j, f in enumerate(a.fault_kinds.split(",")) for i in range(a.faults)]
            + [("witness", a.first_seed + 3000 + i) for i in range(a.witnesses)])
    out = open(a.out, "w") if a.out else None
    for role, seed in jobs:
        t = time.perf_counter()
        if role == "program":
            r = program(cell, seed, a.device)
        elif role == "control":
            r = control(cell, seed, a.device)
        elif role == "witness":
            r = control(cell, seed, a.device, "bf16")
        else:
            r = program(cell, seed, a.device, fault=role.split()[1])
        row = {"role": role, "seed": seed, "s": time.perf_counter() - t, **_drop(r),
               "details": r.get("details")}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if out:
            out.write(json.dumps(row) + "\n")
            out.flush()
    names = [k for k in rows[0] if k not in ("role", "seed", "s", "details")]
    summary = {"summary": a.workload}
    roles = list(dict.fromkeys(r["role"] for r in rows))
    for k in names:
        summary[k] = {role: (max if role in ("program", "witness") else min)(
            r[k] for r in rows if r["role"] == role) for role in roles}
    print(json.dumps(summary), flush=True)
    if out:
        out.write(json.dumps(summary) + "\n")
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
