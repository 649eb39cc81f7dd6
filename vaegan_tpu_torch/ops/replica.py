"""This process's place in a data-parallel step (what GSPMD decides from the
JAX package's shardings).

A data-parallel step runs in ``world`` processes, one per device; process
``rank`` holds some rows of the global batch and a full copy of the state. A
:class:`Replica` says which rows, and the layers, losses and steps take it as
an argument (``replica=``), so that the step computes what the one-process step
computes on the global batch:

- batch statistics are all-reduced (differentiably: the backward of the sum is
  a sum of the cotangents, so gradients and the penalty's double backward see
  the global statistics, ``ops.norm.batch_stats``);
- each mean-reduced loss is written as this process's share of the global mean
  (local mean / world: every process holds as many rows), a sum-reduced loss as
  its local sum, and the gradients and metrics are summed over the processes;
- random draws are the global step's: a fused kernel draws the elements
  ``[base, base + n)`` of the global stream (:meth:`Replica.index_base`), a
  draw on a device generator is made for the global batch and the process
  takes its rows (:meth:`Replica.draw`).

Row layout (:func:`rank_rows`): process r holds rows ``[r B/W, (r+1) B/W)`` of
a global batch of B rows over W processes, the JAX multi-process feed's
layout. A step that accumulates over k microbatches cuts each process's rows
into k, and microbatch j of the global step is the concatenation over the
processes of their j-th pieces; for that to be the global batch's rows
``[j B/k, (j+1) B/k)`` (the one-process accumulating step's microbatch j),
process r holds, of each of the k microbatches, rows ``[r B/(kW), (r+1)
B/(kW))``. A tensor that concatenates ``parts`` batches along its rows (the
critic's ``concat`` batchings) holds, of each part, this process's rows of it
(:meth:`Replica.concat`).

The one-process step is the degenerate case ``LOCAL`` (world 1): no
collective runs and every draw, sum and division is as it was.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed.nn.functional


def rank_rows(batch_size: int, rank: int, world: int, microbatches: int = 1) -> torch.Tensor:
    """The rows of a global batch of ``batch_size`` that process ``rank`` of
    ``world`` holds, in order (module docstring): contiguous rows for one
    microbatch, this process's rows of each microbatch for several."""
    if batch_size % (world * microbatches):
        raise ValueError(f"global batch {batch_size} must be divisible by the world size "
                         f"({world}) times the microbatches ({microbatches})")
    per = batch_size // (world * microbatches)
    micro = batch_size // microbatches
    return torch.cat([torch.arange(j * micro + rank * per, j * micro + (rank + 1) * per)
                      for j in range(microbatches)])


@dataclass(frozen=True)
class Replica:
    """Process ``rank`` of ``world`` in a data-parallel step over ``group``
    (a ``torch.distributed`` process group, ``None`` for the default one);
    ``parts`` > 1 while a tensor holds that many concatenated batches."""

    rank: int = 0
    world: int = 1
    group: Optional[Any] = None
    parts: int = 1

    def __post_init__(self):
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} out of range for world {self.world}")

    @property
    def parallel(self) -> bool:
        return self.world > 1

    def concat(self, parts: int) -> "Replica":
        """This replica for a tensor that concatenates ``parts`` batches."""
        return self if parts == self.parts else replace(self, parts=parts)

    # ---- rows ---------------------------------------------------------------

    def take(self, full: torch.Tensor) -> torch.Tensor:
        """This process's rows of ``full``, a tensor over the global rows."""
        if not self.parallel:
            return full
        n = full.shape[0]
        if n % (self.world * self.parts):
            raise ValueError(f"{n} rows cannot be split into {self.parts} parts over "
                             f"{self.world} processes")
        per = n // (self.world * self.parts)
        if self.parts == 1:
            return full[self.rank * per:(self.rank + 1) * per]
        seg = n // self.parts
        return torch.cat([full[s * seg + self.rank * per: s * seg + (self.rank + 1) * per]
                          for s in range(self.parts)])

    def global_shape(self, local_shape: Sequence[int]) -> tuple:
        """The global tensor's shape for a local one (rows times the world)."""
        return (local_shape[0] * self.world,) + tuple(local_shape[1:])

    def draw(self, local_shape: Sequence[int],
             fn: Callable[[tuple], torch.Tensor]) -> torch.Tensor:
        """``fn(global shape)``, a draw for the global batch, cut to this
        process's rows: every process draws what the one-process step draws."""
        return self.take(fn(self.global_shape(local_shape)))

    def index_base(self, local_numel: int) -> int:
        """The global flat index of this process's first element, for a fused
        kernel's draws (rows are contiguous and equal in size; a multiple of 4,
        one Philox call's words)."""
        if not self.parallel:
            return 0
        if self.parts != 1:
            raise ValueError("a fused draw over concatenated batches has no one index base")
        base = self.rank * local_numel
        if base % 4:
            raise ValueError(f"the index base {base} of a fused draw must be a multiple of 4 "
                             f"(local numel {local_numel})")
        return base

    # ---- sums over the processes --------------------------------------------

    def share(self, local_mean: torch.Tensor) -> torch.Tensor:
        """This process's share of the global mean, given its local mean."""
        return local_mean / self.world if self.parallel else local_mean

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the processes, differentiable:
        ``torch.distributed.nn.functional.all_reduce``, whose backward sums the
        cotangents through the same autograd function, so the penalty's
        grad-of-grad passes through it. Every process must run the backward
        too, in the same order (it is a collective). Newer torch releases mark
        the function deprecated (a ``FutureWarning``) in favour of
        ``torch.distributed._functional_collectives``; it still runs."""
        if not self.parallel:
            return t
        return torch.distributed.nn.functional.all_reduce(
            t, group=torch.distributed.group.WORLD if self.group is None else self.group)

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the processes in place (no graph); returns it."""
        if self.parallel:
            torch.distributed.all_reduce(t, group=self.group)
        return t


LOCAL = Replica()
