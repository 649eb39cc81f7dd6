"""Process-group bootstrap (counterpart of ``vaegan_tpu/parallel/dist.py``).

The JAX package's communication backend is XLA's collectives, started by
``jax.distributed.initialize``; here it is ``torch.distributed``: NCCL between
CUDA devices, gloo on the CPU. One process drives one device, the device
``cuda:LOCAL_RANK``. Under ``torchrun`` the world comes from its environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``);
a process started alone, with none of it, makes the degenerate world of one
process on a free port of localhost. Without a process group ``rank()`` is 0
and ``world_size()`` 1.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as td


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def local_device(device="cuda") -> torch.device:
    """This process's device: ``cuda:LOCAL_RANK`` for a CUDA device given
    without an index (raising when there is no CUDA), else ``device``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    return dev


def initialize(backend: Optional[str] = None, init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               device="cuda", timeout_s: float = 600.0) -> torch.device:
    """Start the default process group and return this process's device.

    ``backend``: unless given, ``"nccl"`` on a CUDA device and ``"gloo"`` on
    the CPU, or where more processes of this host (``LOCAL_WORLD_SIZE``) share
    its cards than it has: NCCL refuses two processes on one card, gloo takes
    CUDA tensors through the host. ``init_method``/``world_size``/``rank``: as
    ``torch.distributed.init_process_group`` takes them; with none given, the
    ``torchrun`` environment, or a world of one. ``timeout_s`` bounds every
    collective, so a process that waits for a missing peer fails instead of
    hanging."""
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if backend is None:
        shared = int(os.environ.get("LOCAL_WORLD_SIZE", "1")) > torch.cuda.device_count()
        backend = "nccl" if dev.type == "cuda" and not shared else "gloo"
    if init_method is None and world_size is None and "WORLD_SIZE" not in os.environ:
        init_method, world_size, rank = f"tcp://127.0.0.1:{_free_port()}", 1, 0
    kw = dict(backend=backend, init_method=init_method, world_size=world_size, rank=rank,
              timeout=datetime.timedelta(seconds=timeout_s))
    if backend == "nccl":
        kw["device_id"] = dev
    td.init_process_group(**{k: v for k, v in kw.items() if v is not None})
    return dev


def is_initialized() -> bool:
    return td.is_available() and td.is_initialized()


def rank(group=None) -> int:
    return td.get_rank(group) if is_initialized() else 0


def world_size(group=None) -> int:
    return td.get_world_size(group) if is_initialized() else 1


def is_multihost() -> bool:
    """Whether more than one process takes part (the JAX package's
    ``process_count() > 1``)."""
    return world_size() > 1


def group_ranks(group) -> list:
    """The global ranks of ``group``'s processes, in their order in ``group``,
    on every process of the default group: each must call this (an
    ``all_gather_object`` over the default group), and the members tell the
    others."""
    mine = ([td.get_global_rank(group, i) for i in range(td.get_world_size(group))]
            if td.get_rank(group) >= 0 else None)
    every = [None] * td.get_world_size()
    td.all_gather_object(every, mine)
    return next(r for r in every if r is not None)


def mesh_groups(num_data: int, num_model: int, ranks=None):
    """The process groups of a ``num_data x num_model`` mesh over the processes
    of global ranks ``ranks`` (default: the default group's), process ``(d,
    m)`` being ``ranks[d * num_model + m]``: ``(data groups, model groups)``,
    the data axis through each model index and the model axis through each data
    index. ``torch.distributed.new_group`` needs every process of the default
    group to make every group, in the same order, members or not, so each
    process makes all of them."""
    ranks = list(range(num_data * num_model)) if ranks is None else list(ranks)
    data = [td.new_group([ranks[d * num_model + m] for d in range(num_data)])
            for m in range(num_model)]
    model = [td.new_group([ranks[d * num_model + m] for m in range(num_model)])
             for d in range(num_data)]
    return data, model


def barrier(group=None) -> None:
    """Wait for every process of the group (no-op without one)."""
    if world_size(group) > 1:
        td.barrier(group=group)


def shutdown() -> None:
    """Destroy the default process group, if there is one."""
    if is_initialized():
        td.destroy_process_group()


def run_processes(argvs: Sequence[Sequence[str]], timeout_s: float,
                  cwd: Optional[str] = None) -> List[Tuple[int, str, str]]:
    """Run each argv, all started together, with this checkout on
    ``PYTHONPATH`` (the processes of a run on one host, each making its own
    process group); wait for every one, killing those still running when a
    wait outlasts ``timeout_s`` or fails. Returns ``(returncode, stdout,
    stderr)`` of each, in order."""
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen(list(argv), cwd=cwd, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for argv in argvs]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout_s))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [(p.returncode, out, err) for p, (out, err) in zip(procs, outs)]
