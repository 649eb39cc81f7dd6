"""Import hygiene of the port: it imports torch, never jax, flax, optax or the
JAX package, not even the JAX package's numpy-only modules."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "vaegan_tpu"}
PKG = ROOT / "vaegan_tpu_torch"
# the git-ignored kernel build directory is not part of the package
FILES = sorted(p for p in PKG.rglob("*.py") if "_build" not in p.relative_to(PKG).parts)
FILES.append(ROOT / "chip_smoke.py")


def imported_roots(path: Path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    assert not imported_roots(path) & FORBIDDEN


def test_the_scan_sees_the_package():
    assert len(FILES) >= 15
    names = {str(p.relative_to(ROOT)) for p in FILES}
    for module in ("losses.py", "train/step.py", "train/optim.py", "ops/spectral_norm.py",
                   "models/networks.py", "interop.py", "data/nifti.py", "data/pipeline.py",
                   "data/fetch.py", "train/loop.py", "checkpoint.py", "api.py",
                   "utils/imaging.py", "utils/metrics.py", "utils/profiling.py", "cli.py",
                   "search.py", "entry.py", "bench.py", "ops/replica.py", "parallel/__init__.py",
                   "parallel/dist.py", "parallel/mesh.py", "parallel/train.py",
                   "examples/__init__.py", "examples/reproduce_headline.py",
                   "examples/train_vaegan.py", "examples/train_multichip.py",
                   "tools/__init__.py", "tools/common.py", "tools/make_nifti_dataset.py",
                   "tools/paper_probe.py", "tools/gan_only_budget.py",
                   "tools/large_batch_recipe.py", "tools/edges_multiseed.py",
                   "tools/profile_step_residual.py", "tools/conv_fusion_evidence.py",
                   "tools/paper_loss_fusion_evidence.py", "tools/run_256dp_virtual_mesh.py"):
        assert f"vaegan_tpu_torch/{module}" in names, module
    assert "torch" in imported_roots(ROOT / "vaegan_tpu_torch" / "ops" / "fused.py")


def test_importing_the_package_loads_no_jax():
    """Every module of the port, imported in a fresh interpreter, pulls in
    neither jax nor the JAX package (a transitive import would not show in the
    scan above)."""
    import subprocess
    import sys

    modules = sorted(".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
                     for p in FILES if p.parent != ROOT)
    code = ("import importlib, sys\n"
            f"for m in {modules!r}: importlib.import_module(m)\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in "
            f"{sorted(FORBIDDEN)!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
