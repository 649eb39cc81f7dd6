"""The cost of one step, counted as it runs: the port's counterpart of XLA's
``compiled.cost_analysis()``, which the JAX bench's ``--roofline`` reads.

:func:`step_cost` runs ``fn(*args)`` once under a ``TorchDispatchMode`` that
sees every ATen op the call runs, forward, backward and the gradient
penalty's grad-of-grad alike, and adds up

- ``"flops"``: each op's count from ``torch.utils.flop_counter.flop_registry``
  (convolutions and their backward, ``mm``, ``addmm``, ``bmm``: two per
  multiply-add), plus the operations of the hand-written kernels
  (``ops.fused.kernel_cost``). Other elementwise work is not counted, so this
  is a little below XLA's figure, which counts every float op;
- ``"bytes accessed"``: for every op that computes, the bytes of its distinct
  input tensors (once per storage; an ``out=`` argument is not read, nor is the
  destination of ``copy_``, ``fill_`` or ``zero_``) plus the bytes it writes
  (the tensors it returns and the arguments it writes in place). A view or a
  metadata op (every output aliases an input, nothing is written) and an
  allocation (``empty*``) count 0. XLA sums the same over its HLO ops after
  fusion; eager PyTorch does not fuse, so this figure counts every launch's own
  traffic, intermediates included.

The five kernels of ``ops.fused`` are ctypes launches, which a dispatch mode
cannot see. While ``fused.counting`` runs, each wrapper reports its call where
it adds to ``fused.LAUNCHES``, with its bytes (each input read once, each
output written once) and operations (``fused.kernel_cost``); on a CPU tensor
the plain version's own ops are left out of the count and the same formula
counted in their place, so both devices count a kernel alike. ``"kernels"``
holds, per kernel, its calls and what they added, and ``"ops"`` every op and
kernel call that moved bytes, in order, as ``(name, bytes)``: the passes a
byte audit names. The count reads only
shapes, dtypes and storages: it adds no device synchronisation, and outside
:func:`step_cost` a launch only tests that no count runs.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from vaegan_tpu_torch.ops import fused

_aten = torch.ops.aten
# allocations: no byte of memory is read or written
_FREE = {_aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
         _aten.new_empty_strided}
# ops that write their first argument without reading it
_WRITE_ONLY = {_aten.copy_, _aten.fill_, _aten.zero_}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def op_bytes(func, args, kwargs, out) -> int:
    """The bytes one ATen op call reads and writes (module docstring)."""
    packet = func._overloadpacket
    if packet in _FREE:
        return 0
    schema = func._schema
    written = {a.name for a in schema.arguments
               if a.alias_info is not None and a.alias_info.is_write}
    new = [r.alias_info is None for r in schema.returns]
    if not written and not any(new):
        return 0
    named = {a.name: v for a, v in zip(schema.arguments, args)}
    named.update(kwargs)
    reads: Dict[int, int] = {}
    for name, v in named.items():
        if name == "out" or (name in written and packet in _WRITE_ONLY):
            continue
        for t in _tensors(v):
            key = t.untyped_storage().data_ptr()
            reads[key] = max(reads.get(key, 0), _nbytes(t))
    outs = out if len(schema.returns) > 1 else (out,)
    writes = sum(_nbytes(t) for name in written for t in _tensors(named.get(name)))
    writes += sum(_nbytes(t) for is_new, o in zip(new, outs) if is_new for t in _tensors(o))
    return sum(reads.values()) + writes


class _Count(TorchDispatchMode):
    """Adds up the flops and bytes of the ops it sees, and the kernels'."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.ops: List[Tuple[str, int]] = []
        self._paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._paused:
            count = flop_registry.get(func._overloadpacket)
            if count is not None:
                self.flops += count(*args, **kwargs, out_val=out)
            nbytes = op_bytes(func, args, kwargs, out)
            self.bytes += nbytes
            if nbytes:
                self.ops.append((str(func), nbytes))
        return out

    @contextlib.contextmanager
    def paused(self):
        """Leave out the ops that run inside (a kernel's plain version)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    def add(self, name: str, nbytes: int, ops: int) -> None:
        """One call of a fused kernel, with its own bytes and operations."""
        k = self.kernels.setdefault(name, {"calls": 0, "bytes": 0, "flops": 0})
        k["calls"] += 1
        k["bytes"] += nbytes
        k["flops"] += ops
        self.flops += ops
        self.bytes += nbytes
        self.ops.append((f"vaegan::{name}", nbytes))


def step_cost(fn: Callable, *args) -> Dict[str, Any]:
    """Run ``fn(*args)`` once and count it: ``{"flops", "bytes accessed",
    "kernels", "ops"}`` (module docstring); ``"result"`` is what ``fn``
    returned."""
    mode = _Count()
    with fused.counting(mode), mode:
        result = fn(*args)
    return {"flops": float(mode.flops), "bytes accessed": float(mode.bytes),
            "kernels": mode.kernels, "ops": mode.ops, "result": result}
