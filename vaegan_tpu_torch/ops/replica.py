"""This process's place in a data x model step (what GSPMD decides from the
JAX package's shardings).

A parallel step runs in ``D x M`` processes, one per device, laid out as the
JAX package's mesh (``vaegan_tpu/parallel/mesh.py``): process ``(d, m)`` has
global rank ``d M + m``. It holds rows ``[d B/D, (d+1) B/D)`` of the global
batch (:func:`rank_rows`), and, with a spatial axis (``spatial``), the stripe
``[m H/M, (m+1) H/M)`` of every activation's H axis; without one the ``M``
processes of a data row hold the same rows. A :class:`Replica` says which, and
the layers, losses and steps take it as an argument (``replica=``), so that
the step computes what the one-process step computes on the global batch:

- batch statistics are all-reduced, differentiably (the backward of a sum is a
  sum of the cotangents, so gradients and the penalty's double backward see
  the global statistics, ``ops.norm.batch_stats``): over every process under
  spatial sharding (its stripes are distinct elements), over the data axis
  otherwise (the model axis holds copies);
- a convolution over a stripe first takes its neighbours' boundary rows
  (:meth:`Replica.halo`), zeros at the image's top and bottom;
- the critic's head gathers what the model axis split (:meth:`Replica.gather`):
  the pooled stripes before the flatten, the outputs of each linear whose
  kernel is split over the model axis (tensor parallelism, ``layers.Linear``);
- each loss is written as this process's share of the global loss, so that the
  shares of all ``D M`` processes add up to it: a local mean over ``D M``
  (:meth:`Replica.share`; a value the model axis holds in copies is counted
  once a data row), a local sum over the model axis's copies
  (:meth:`Replica.share_sum`), and the gradients and metrics are summed over
  the processes: a replicated tensor's over all of them (each process's
  gradient holds the part its own shares and copies reached), a tensor split
  over the model axis over the data axis (the copies of that slice);
- random draws are the global step's: a fused kernel draws the elements of the
  global stream its rows and stripe hold (:meth:`Replica.index_map`), a draw
  on a device generator is made for the global batch and the process takes
  its rows and stripe (:meth:`Replica.draw`).

Every sum names its axis (``over``): ``"data"``, ``"model"`` or ``"mesh"``
(all ``D M`` processes). All collectives are sums (``all_reduce``); a gather
is the sum of zero-padded parts, which costs ``M`` times the bytes of an
all-gather and is for the small tensors of the head and the halos.

Row layout (:func:`rank_rows`): process d holds rows ``[d B/D, (d+1) B/D)`` of
a global batch of B rows over D data indices, the JAX multi-process feed's
layout. A step that accumulates over k microbatches cuts each process's rows
into k, and microbatch j of the global step is the concatenation over the
processes of their j-th pieces; for that to be the global batch's rows
``[j B/k, (j+1) B/k)`` (the one-process accumulating step's microbatch j),
process d holds, of each of the k microbatches, rows ``[d B/(kD), (d+1)
B/(kD))``. A tensor that concatenates ``parts`` batches along its rows (the
critic's ``concat`` batchings) holds, of each part, this process's rows of it
(:meth:`Replica.concat`).

The one-process step is the degenerate case ``LOCAL`` (1 x 1): no collective
runs and every draw, sum and division is as it was.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Optional, Sequence, Tuple

import torch
import torch.distributed.nn.functional


def rank_rows(batch_size: int, rank: int, world: int, microbatches: int = 1) -> torch.Tensor:
    """The rows of a global batch of ``batch_size`` that data index ``rank`` of
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
    """Process ``(rank, model_rank)`` of a ``world x num_model`` mesh.

    ``group``: the data axis through this process (the processes that hold
    the same model index), ``model_group``: the model axis through it,
    ``mesh_group``: every process of the mesh (``None`` for the default
    process group). ``spatial``: the model axis splits H. ``parts`` > 1 while
    a tensor holds that many concatenated batches."""

    rank: int = 0
    world: int = 1
    group: Optional[Any] = None
    parts: int = 1
    model_rank: int = 0
    num_model: int = 1
    model_group: Optional[Any] = None
    mesh_group: Optional[Any] = None
    spatial: bool = False

    def __post_init__(self):
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} out of range for world {self.world}")
        if not 0 <= self.model_rank < self.num_model:
            raise ValueError(f"model rank {self.model_rank} out of range for "
                             f"{self.num_model} model processes")

    @property
    def parallel(self) -> bool:
        return self.world * self.num_model > 1

    @property
    def lead(self) -> bool:
        """Process (0, 0), global rank 0: the one that writes files."""
        return self.rank == 0 and self.model_rank == 0

    @property
    def split_h(self) -> int:
        """How many stripes an H axis is cut into (1 without a spatial axis)."""
        return self.num_model if self.spatial else 1

    @property
    def stats_axis(self) -> str:
        """The axis a batch statistic sums over: every process holds distinct
        elements under spatial sharding, the model axis holds copies otherwise."""
        return "mesh" if self.spatial else "data"

    def concat(self, parts: int) -> "Replica":
        """This replica for a tensor that concatenates ``parts`` batches."""
        return self if parts == self.parts else replace(self, parts=parts)

    def axis(self, over: str) -> Tuple[Any, int]:
        """``(group, size)`` of the axis ``over``: data, model or mesh."""
        if over == "data":
            return self.group, self.world
        if over == "model":
            return self.model_group, self.num_model
        if over == "mesh":
            return self.mesh_group, self.world * self.num_model
        raise ValueError(f"unknown axis {over!r} (data, model or mesh)")

    # ---- rows and stripes ---------------------------------------------------

    def _rows(self, full: torch.Tensor) -> torch.Tensor:
        if self.world == 1:
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

    def stripe(self, full: torch.Tensor, h_dim: int) -> torch.Tensor:
        """This process's stripe of ``full``'s axis ``h_dim`` (all of it without
        a spatial axis)."""
        k = self.split_h
        if k == 1:
            return full
        h = full.shape[h_dim]
        if h % k:
            raise ValueError(f"H {h} cannot be cut into {k} stripes")
        return full.narrow(h_dim, self.model_rank * (h // k), h // k)

    def take(self, full: torch.Tensor, h_dim: Optional[int] = None) -> torch.Tensor:
        """This process's rows of ``full``, a tensor over the global rows, and,
        given the H axis ``h_dim`` (2 for NCHW, 1 for NHWC), its stripe of
        them; a per-sample tensor (no ``h_dim``) is cut by rows alone."""
        rows = self._rows(full)
        return rows if h_dim is None else self.stripe(rows, h_dim)

    def global_shape(self, local_shape: Sequence[int], h_dim: Optional[int] = None) -> tuple:
        """The global tensor's shape for a local one: rows times the data axis,
        and H times the stripes when ``h_dim`` is given."""
        shape = [local_shape[0] * self.world] + list(local_shape[1:])
        if h_dim is not None:
            shape[h_dim] *= self.split_h
        return tuple(shape)

    def draw(self, local_shape: Sequence[int], fn: Callable[[tuple], torch.Tensor],
             h_dim: Optional[int] = None) -> torch.Tensor:
        """``fn(global shape)``, a draw for the global batch, cut to this
        process's rows (and stripe of ``h_dim``): every process draws what the
        one-process step draws."""
        return self.take(fn(self.global_shape(local_shape, h_dim)), h_dim)

    def index_map(self, local_shape: Sequence[int]) -> Tuple[int, int, int]:
        """``(base, L, G)`` for a fused kernel's draws over this process's
        (N, C, H, W) tensor: local element e (flat NHWC) is global element
        ``base + (e // L) G + e % L`` of the global tensor's flat NHWC index,
        with L the local elements of an image and G the global ones. Without a
        spatial axis L = G and the map is ``base + e``."""
        n, c, h, w = local_shape
        local = h * w * c
        if not self.parallel:
            return 0, local, local
        if self.parts != 1:
            raise ValueError("a fused draw over concatenated batches has no one index map")
        full_h = h * self.split_h
        g = full_h * w * c
        first_row = self.model_rank * h if self.spatial else 0
        base = (self.rank * n * full_h + first_row) * w * c
        if base % 4:
            raise ValueError(f"the index base {base} of a fused draw must be a multiple of 4 "
                             f"(local shape {tuple(local_shape)})")
        return base, local, g

    # ---- sums over the processes --------------------------------------------

    def share(self, local_mean: torch.Tensor) -> torch.Tensor:
        """This process's share of the global mean, given its local mean (every
        process holds as many elements: distinct stripes, or copies of its
        data row's)."""
        n = self.world * self.num_model
        return local_mean / n if n > 1 else local_mean

    def share_sum(self, local_sum: torch.Tensor) -> torch.Tensor:
        """This process's share of a global sum, given its local sum: all of it
        when its elements are its own (its stripe), its part of the model
        axis's copies otherwise."""
        return local_sum if self.split_h == self.num_model else local_sum / self.num_model

    def all_reduce(self, t: torch.Tensor, over: str) -> torch.Tensor:
        """The sum of ``t`` over the axis ``over``, differentiable:
        ``torch.distributed.nn.functional.all_reduce``, whose backward sums the
        cotangents through the same autograd function, so the penalty's
        grad-of-grad passes through it. Every process must run the backward
        too, in the same order (it is a collective). Newer torch releases mark
        the function deprecated (a ``FutureWarning``) in favour of
        ``torch.distributed._functional_collectives``; it still runs."""
        group, size = self.axis(over)
        if size == 1:
            return t
        return torch.distributed.nn.functional.all_reduce(
            t, group=torch.distributed.group.WORLD if group is None else group)

    def all_reduce_(self, t: torch.Tensor, over: str) -> torch.Tensor:
        """``t`` summed over the axis ``over`` in place (no graph); returns it."""
        group, size = self.axis(over)
        if size > 1:
            torch.distributed.all_reduce(t, group=group)
        return t

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The model axis's pieces of ``t`` concatenated along ``dim`` in model
        order, differentiable: the sum of each piece padded with zeros to its
        place (the backward takes this process's slice of the summed
        cotangents)."""
        k, m = self.num_model, self.model_rank
        if k == 1:
            return t
        size = t.shape[dim]
        zeros = lambda n: t.new_zeros(t.shape[:dim] + (n,) + t.shape[dim + 1:])  # noqa: E731
        parts = [p for p in (zeros(m * size), t, zeros((k - 1 - m) * size)) if p.shape[dim]]
        return self.all_reduce(torch.cat(parts, dim), "model")

    def halo(self, x: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
        """``x`` (N, C, h, W), this process's stripe of H, with ``top`` rows of
        the stripe above and ``bottom`` rows of the stripe below around it:
        zeros beyond the image's first and last row."""
        k, m = self.split_h, self.model_rank
        if k == 1 or top + bottom == 0:
            return x
        h = x.shape[2]
        if top > h or bottom > h:
            raise ValueError(f"a stripe of {h} rows cannot lend a halo of {max(top, bottom)}")
        # each process lends its first `bottom` rows up and its last `top` rows down
        lent = torch.cat([x[:, :, :bottom], x[:, :, h - top:]], 2)
        every = self.gather(lent, 2)
        n = top + bottom
        above = (every[:, :, (m - 1) * n + bottom:m * n] if m > 0
                 else x.new_zeros(x.shape[:2] + (top, x.shape[3])))
        below = (every[:, :, (m + 1) * n:(m + 1) * n + bottom] if m < k - 1
                 else x.new_zeros(x.shape[:2] + (bottom, x.shape[3])))
        return torch.cat([above, x, below], 2)


LOCAL = Replica()
