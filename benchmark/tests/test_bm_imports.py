"""Nothing the benchmark loads is JAX, flax or the JAX package (compared by
whole top-level names), and the reference loads nothing of the program."""

import ast
import json
import subprocess
import sys

from conftest import BENCH

RUN_TINY = f"""
import sys, time, json
sys.path[:0] = [{str(BENCH)!r}, {str(BENCH.parent)!r}, {str(BENCH / 'tests')!r}]
import torch; torch.set_num_threads(1)
import run
from harness import spec
from conftest import tiny
b = spec.load_benchmark()
for name in ("notebook.train_b16", "notebook.recon_b64"):
    run.measure(tiny(spec.find_cell(name, b)), 3, 0.3, False, "cpu", time.perf_counter())
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
print(json.dumps(run.forbidden_modules()))
"""


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", RUN_TINY], capture_output=True, text=True,
                         timeout=600, cwd=BENCH.parent)
    assert out.returncode == 0, out.stderr[-3000:]
    top, found = (json.loads(x) for x in out.stdout.strip().splitlines()[-2:])
    assert "vaegan_tpu_torch" in top
    assert found == [] and not {"jax", "jaxlib", "flax", "vaegan_tpu"} & set(top)


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    import run
    import vaegan_tpu_torch  # noqa: F401
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "vaegan_tpu_torch_extra.x", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "vaegan_tpu.models", sys)
    assert run.forbidden_modules() == ["vaegan_tpu"]


def test_reference_imports_nothing_of_the_program():
    allowed = {"torch", "numpy", "reference", "__future__", "dataclasses", "typing",
               "contextlib", "math"}
    for path in (BENCH / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] in allowed, f"{path.name} imports {n}"
    code = (f"import sys; sys.path.insert(0, {str(BENCH)!r}); "
            "import reference.model, reference.train, reference.serve, reference.draws, "
            "reference.precision; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd="/")
    assert out.returncode == 0, out.stderr
    assert "vaegan_tpu_torch" not in out.stdout and "jax" not in out.stdout
