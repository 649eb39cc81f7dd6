"""Checkpoint / resume (port of ``vaegan_tpu/checkpoint.py``).

A checkpoint is one ``<directory>/<step>.pt`` file written with ``torch.save``:
everything a :class:`~vaegan_tpu_torch.train.state.TrainState` carries (both
modules' ``state_dict``: parameters, BN running statistics, spectral u/v; both
optimizers' state; the step count; the stale G metrics; the generator EMA). It
is written under a temporary name in the same directory and ``os.replace``d into
place, so a run killed mid-save leaves a tmp file that no later run reads, never
a truncated checkpoint. The last ``max_to_keep`` steps are kept.

Checkpoints of the JAX package (orbax directories) are not read here: bring
those across with ``interop.load_jax_train_state``.
"""

from __future__ import annotations

import os
import pickle
import re
from typing import List, Optional

import torch

from vaegan_tpu_torch.train.state import TrainState

_NAME = re.compile(r"^(\d+)\.pt$")
FORMAT = 1


def _device(state: TrainState) -> torch.device:
    return next(state.generator.parameters()).device


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def all_steps(self) -> List[int]:
        """The steps with a complete checkpoint, ascending (tmp files are not)."""
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, *, force: bool = False) -> None:
        """Persist ``state`` under its step number. An already-saved step is
        kept unless ``force=True``, which overwrites it (a re-import must not
        leave the old weights in place)."""
        step = int(state.step)
        path = self._path(step)
        if os.path.exists(path) and not force:
            return
        payload = {
            "format": FORMAT, "step": step,
            "generator": state.generator.state_dict(), "critic": state.critic.state_dict(),
            "opt_g": state.opt_g.state_dict(), "opt_d": state.opt_d.state_dict(),
            "g_metrics": dict(state.g_metrics), "g_ema": state.g_ema,
        }
        tmp = f"{path}.tmp{os.getpid()}"
        try:
            torch.save(payload, tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.unlink(self._path(old))

    def _load(self, step: Optional[int], device, mmap: bool = False) -> dict:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        return torch.load(self._path(step), map_location=device, weights_only=True, mmap=mmap)

    def restore(self, template: TrainState, step: Optional[int] = None) -> TrainState:
        """Load the checkpoint at ``step`` (default the latest) into ``template``
        (its modules and optimizers, in place, on the template's device) and
        return it. The template must match the checkpoint: the same modules and,
        with or without a generator EMA, the same as it was saved."""
        payload = self._load(step, _device(template))
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
        file is memory-mapped, not read whole."""
        try:
            payload = self._load(step, "cpu", mmap=True)
            return payload["g_ema"] is not None
        except (OSError, RuntimeError, KeyError, TypeError, ValueError, EOFError,
                pickle.UnpicklingError):
            return None

    def wait(self) -> None:
        """Saves are synchronous; kept for the JAX package's interface."""

    def close(self) -> None:
        """Nothing to release; kept for the JAX package's interface."""
