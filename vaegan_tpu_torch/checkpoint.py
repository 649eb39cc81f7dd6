"""Checkpoint / resume (port of ``vaegan_tpu/checkpoint.py``).

A checkpoint is one ``<directory>/<step>.pt`` file written with ``torch.save``:
everything a :class:`~vaegan_tpu_torch.train.state.TrainState` carries (both
modules' ``state_dict``: parameters, BN running statistics, spectral u/v; both
optimizers' state; the step count; the stale G metrics; the generator EMA). It
is written under a temporary name in the same directory and ``os.replace``d into
place, so a run killed mid-save leaves a tmp file that no later run reads, never
a truncated checkpoint. The last ``max_to_keep`` steps are kept.

Under tensor parallelism (``parallel.shard_state``) each process holds rows of
the critic head's kernels and of their optimizer state. The file keeps the
one-process layout all the same: a save gathers those tensors over the model
axis first (every process of data row 0 takes part, process 0 writes), and a
restore into a state that holds slices cuts them from the whole tensors. So a
tensor-parallel run's checkpoint loads into a one-process state, and the other
way round.

The JAX package's checkpoints, Orbax ``<step>/`` directories, are read too
(``orbax_reader``, with neither JAX nor Orbax): ``all_steps``, ``latest_step``,
``restore`` and ``saved_has_g_ema`` see both kinds, and ``restore`` of an Orbax
step loads it as ``interop.load_jax_train_state`` would (the critic's pool shape
from the template). ``save`` always writes ``<step>.pt``, and pruning removes
only this package's files, so a TPU run's directory can be resumed here and
keeps its Orbax steps. Where a step has both, the ``.pt`` is read.
"""

from __future__ import annotations

import os
import pickle
import re
from typing import List, Optional

import torch

from vaegan_tpu_torch import interop, orbax_reader
from vaegan_tpu_torch.ops.replica import LOCAL, Replica
from vaegan_tpu_torch.train.state import TrainState

_NAME = re.compile(r"^(\d+)\.pt$")
_ORBAX = re.compile(r"^\d+$")          # a step directory (a crashed save's has a suffix)
FORMAT = 1


def _device(state: TrainState) -> torch.device:
    return next(state.generator.parameters()).device


def _split_linears(state: TrainState):
    """``(name, layer, index of its weight among the critic's parameters)`` of
    each critic linear that holds a slice of its kernel."""
    index = {id(p): i for i, p in enumerate(state.critic.parameters())}
    return [(name, m, index[id(m.weight)]) for name, m in state.critic.named_modules()
            if getattr(m, "tp", (0, 1))[1] > 1]


def _whole(state: TrainState, replica: Replica):
    """The critic's and its optimizer's state dicts with each sliced kernel,
    and its optimizer state of the kernel's shape, gathered over the model
    axis (a collective of the model axis)."""
    critic, opt_d = state.critic.state_dict(), state.opt_d.state_dict()
    split = _split_linears(state)
    if not split:
        return critic, opt_d
    opt_d = dict(opt_d, state={i: dict(v) for i, v in opt_d["state"].items()})
    with torch.no_grad():
        for name, m, i in split:
            shape = m.weight.shape
            critic[f"{name}.weight"] = replica.gather(m.weight.detach(), 0)
            for k, v in opt_d["state"].get(i, {}).items():
                if isinstance(v, torch.Tensor) and v.shape == shape:
                    opt_d["state"][i][k] = replica.gather(v, 0)
    return critic, opt_d


def _cut(template: TrainState, payload: dict) -> dict:
    """``payload`` with each whole kernel that ``template`` holds a slice of
    cut to that slice (and its optimizer state)."""
    split = _split_linears(template)
    if not split:
        return payload
    critic = dict(payload["critic"])
    opt_d = dict(payload["opt_d"], state={i: dict(v) for i, v in
                                          payload["opt_d"]["state"].items()})
    for name, m, i in split:
        rows = m.rows(*m.tp)
        whole = critic[f"{name}.weight"].shape
        critic[f"{name}.weight"] = critic[f"{name}.weight"][rows]
        for k, v in opt_d["state"].get(i, {}).items():
            if isinstance(v, torch.Tensor) and v.shape == whole:
                opt_d["state"][i][k] = v[rows].clone()
    return dict(payload, critic=critic, opt_d=opt_d)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def _pt_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m)

    def _orbax_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def _orbax_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory) if _ORBAX.match(n)
                      and os.path.isfile(os.path.join(self._orbax_dir(int(n)), "default",
                                                      "_METADATA")))

    def _is_orbax(self, step: int) -> bool:
        return not os.path.exists(self._path(step)) and step in self._orbax_steps()

    def all_steps(self) -> List[int]:
        """The steps with a complete checkpoint of either kind, ascending (tmp
        files and a crashed Orbax save's ``*.orbax-checkpoint-tmp*`` are not)."""
        return sorted(set(self._pt_steps()) | set(self._orbax_steps()))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, *, force: bool = False,
             replica: Replica = LOCAL) -> None:
        """Persist ``state`` under its step number. An already-saved step is
        kept unless ``force=True``, which overwrites it (a re-import must not
        leave the old weights in place). In a parallel run every process calls
        it with its ``replica``: process 0 writes, after data row 0 has
        gathered the critic head's slices (module docstring)."""
        if replica.rank != 0:
            return
        step = int(state.step)
        path = self._path(step)
        skip = os.path.exists(path) and not force
        if _split_linears(state):
            # the gather below is a collective of the model axis, so its processes must
            # agree; process 0 decides, since the others may not see its directory
            flag = torch.tensor([float(skip and replica.lead)], device=_device(state))
            skip = bool(replica.all_reduce_(flag, "model").item())
        if skip:
            return
        critic, opt_d = _whole(state, replica)
        if not replica.lead:
            return
        payload = {
            "format": FORMAT, "step": step,
            "generator": state.generator.state_dict(), "critic": critic,
            "opt_g": state.opt_g.state_dict(), "opt_d": opt_d,
            "g_metrics": dict(state.g_metrics), "g_ema": state.g_ema,
        }
        tmp = f"{path}.tmp{os.getpid()}"
        try:
            torch.save(payload, tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        for old in self._pt_steps()[:-self.max_to_keep]:
            os.unlink(self._path(old))

    def _step(self, step: Optional[int]) -> int:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return step

    def _load(self, step: int, device, mmap: bool = False) -> dict:
        return torch.load(self._path(step), map_location=device, weights_only=True, mmap=mmap)

    def restore(self, template: TrainState, step: Optional[int] = None) -> TrainState:
        """Load the checkpoint at ``step`` (default the latest) into ``template``
        (its modules and optimizers, in place, on the template's device) and
        return it. The template must match the checkpoint: the same modules and,
        with or without a generator EMA, the same as it was saved; a template
        that holds slices of the critic head's kernels gets its slices."""
        step, dev = self._step(step), _device(template)
        if self._is_orbax(step):
            tree = orbax_reader.read_tree(self._orbax_dir(step))
            payload = interop.jax_train_state_payload(template, tree,
                                                      template.critic.pool_shape)
            # the modules and optimizers copy their tensors to their own device;
            # the metrics and the EMA are taken as they are, so they move here
            for key in ("g_metrics", "g_ema"):
                if payload[key] is not None:
                    payload[key] = {k: v.to(dev) for k, v in payload[key].items()}
        else:
            payload = self._load(step, dev)
        payload = _cut(template, payload)
        if (payload["g_ema"] is None) != (template.g_ema is None):
            raise ValueError(
                f"checkpoint {'carries' if payload['g_ema'] is not None else 'has no'} "
                "generator EMA but the template "
                f"{'has none' if template.g_ema is None else 'does'}")
        template.generator.load_state_dict(payload["generator"], strict=True)
        template.critic.load_state_dict(payload["critic"], strict=True)
        template.opt_g.load_state_dict(payload["opt_g"])
        template.opt_d.load_state_dict(payload["opt_d"])
        template.step = int(payload["step"])
        template.g_metrics = dict(payload["g_metrics"])
        if template.g_ema is not None:
            if set(payload["g_ema"]) != set(template.g_ema):
                raise ValueError("the checkpoint's EMA keys do not match the generator's")
            template.g_ema = dict(payload["g_ema"])
        return template

    def saved_has_g_ema(self, step: Optional[int] = None) -> Optional[bool]:
        """Whether the saved state carries a generator EMA, so a caller can build
        a matching restore template whatever its own config says. ``None`` when
        that cannot be told: no checkpoint, or a file that cannot be read. The
        file is memory-mapped, not read whole; of an Orbax step only
        ``_METADATA`` is read (the value type of the ``('g_ema',)`` entry)."""
        try:
            step = self._step(step)
            if self._is_orbax(step):
                for entry in orbax_reader.tree_metadata(self._orbax_dir(step)).values():
                    keys = [k.get("key") for k in entry.get("key_metadata", [])]
                    if keys and keys[0] == "g_ema":
                        return entry["value_metadata"]["value_type"] != "None"
                return False
            return self._load(step, "cpu", mmap=True)["g_ema"] is not None
        except (OSError, RuntimeError, KeyError, TypeError, ValueError, EOFError,
                AttributeError, pickle.UnpicklingError):
            return None

    def wait(self) -> None:
        """Saves are synchronous; kept for the JAX package's interface."""

    def close(self) -> None:
        """Nothing to release; kept for the JAX package's interface."""
