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
                   "models/networks.py", "interop.py"):
        assert f"vaegan_tpu_torch/{module}" in names, module
    assert "torch" in imported_roots(ROOT / "vaegan_tpu_torch" / "ops" / "fused.py")
