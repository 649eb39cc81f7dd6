"""Build the package's CUDA kernels at first use and load them with ctypes.

``vaegan_tpu_torch/csrc/<name>.cu`` becomes a shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a`` into ``vaegan_tpu_torch/_build/``
(git-ignored) under a name keyed on a hash of the source, the ``csrc`` headers it
includes and the flags — an edited source or header builds anew, an unchanged one
loads the library already there. :func:`build_all` starts one ``nvcc`` per source,
all at once.

Nothing here runs at import: the CPU test suite imports every module on a
machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import concurrent.futures
import functools
import hashlib
import os
import shutil
import re
import subprocess
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the toolkit's
    default install location."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on the PATH); "
                       "the CUDA kernels are built from source at first use")


SOURCES = ("bn_act_dropout", "reparam_kl", "recon_loss_sums")

_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _source_hash(source: Path) -> "hashlib._Hash":
    """sha256 of the source and of every ``csrc`` header it includes, transitively."""
    h = hashlib.sha256()
    seen, todo = set(), [source]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        text = path.read_bytes()
        h.update(path.name.encode() + b"\0" + text)
        todo += [CSRC / m.decode() for m in _INCLUDE.findall(text)
                 if (CSRC / m.decode()).is_file()]
    return h


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built; returns
    the library's path. The compiler's report (registers, shared memory, spills
    from ``-Xptxas -v``) is kept beside the library as ``<library>.log``."""
    source = CSRC / f"{name}.cu"
    if not source.is_file():
        raise KeyError(f"no CUDA source csrc/{name}.cu")
    h = _source_hash(source)
    h.update(" ".join(NVCC_FLAGS).encode())
    path = BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    Path(f"{path}.log").write_text(proc.stdout)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"CUDA kernel build failed: {name}.cu (nvcc exit "
                           f"{proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, path)   # atomic: a concurrent loader never sees half a file
    return path


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Build the given sources, one ``nvcc`` each, all started together;
    returns ``{name: library path}``. Raises the first build's error."""
    names = list(names)
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(names)) as pool:
        return dict(zip(names, pool.map(build, names)))


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<name>.cu`` (built first if needed)."""
    return ctypes.CDLL(str(build(name)))
