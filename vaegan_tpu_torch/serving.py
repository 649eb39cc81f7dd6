"""Serving bundles: the eval-mode entry points exported with ``torch.export``
(port of ``vaegan_tpu/serving.py``, which ``jax.export``s them to StableHLO).

:func:`export_entries` exports reconstruct, encode and decode with the trained
weights inside each program; :func:`save_bundle` writes them with
``torch.export.save`` beside a JSON manifest (shapes, dtypes, platforms and the
resolved config), and :func:`load_bundle` loads and serves them with torch and
``ops.fused`` alone: no model code, no checkpoint plumbing.

- the batch dimension is symbolic (``torch.export.Dim("b")``: one program
  serves any batch size) unless ``batch_size`` pins it; H and W are fixed;
- eval-mode semantics are frozen in: BN running statistics, dropout off,
  z = mu;
- ``use_pallas`` is honoured: a fused BN is the registered operator
  ``torch.ops.vaegan.bn_act_dropout`` (``ops.fused``), which launches the
  hand-written kernel on a CUDA tensor and runs its plain version on a CPU one,
  so one program serves on both (the JAX bundle turned its Pallas kernels off,
  since they have no CPU lowering);
- ``platforms`` lists the devices a bundle may be loaded on. Programs are
  stored on the CPU and moved to the requested device when loaded
  (``torch.export.passes.move_to_device_pass``), so a bundle exported on a
  host without a card serves on one;
- served float32 convolutions run in IEEE float32, as the in-process model's
  do (``ops.ieee_float32``), not in the TF32 that PyTorch's cuDNN
  default would pick.

Layout::

    out_dir/
      manifest.json      # shapes, dtypes, platforms, resolved config
      reconstruct.pt2    # (b, H, W, C) -> ((b, H, W, C), scalar MSE)
      encode.pt2         # (b, H, W, C) -> (b, h, w, latent)
      decode.pt2         # (b, h, w, latent) -> (b, H, W, C)
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.export import ExportedProgram
from torch.export.passes import move_to_device_pass

from vaegan_tpu_torch.ops import ieee_float32
# registers torch.ops.vaegan.bn_act_dropout, which the programs call
from vaegan_tpu_torch.ops import fused  # noqa: F401

MANIFEST_NAME = "manifest.json"
_ARTIFACT_SUFFIX = ".pt2"
# bump when the bundle layout / calling convention changes; version 1 was the
# generator's state_dict, rebuilt with the model code at load
BUNDLE_VERSION = 2
PLATFORMS = ("cpu", "cuda")


def _entry_modules(cfg, state) -> Dict[str, torch.nn.Module]:
    """The three eval-mode entry points as modules over the state's generator."""
    from vaegan_tpu_torch.inference import reconstruction

    gen = state.generator

    class Reconstruct(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.generator = gen

        def forward(self, batch):
            return reconstruction(cfg, self.generator, batch)

    class Encode(Reconstruct):
        def forward(self, batch):
            return self.generator.encode(batch)

    class Decode(Reconstruct):
        def forward(self, z):
            return self.generator.decode(z)

    return {"reconstruct": Reconstruct(), "encode": Encode(), "decode": Decode()}


def _check_platforms(platforms: Sequence[str]) -> None:
    if not platforms or any(p not in PLATFORMS for p in platforms):
        raise ValueError(f"platforms must be among {PLATFORMS}, got {list(platforms)}")


def export_entries(cfg, state, *, image_size: Optional[int] = None,
                   platforms: Sequence[str] = PLATFORMS,
                   batch_size: Optional[int] = None) -> Dict[str, ExportedProgram]:
    """Export reconstruct / encode / decode as ``ExportedProgram``s on the CPU,
    traced on the device the state's generator lives on. ``batch_size=None``
    exports a symbolic batch dimension; an int pins it."""
    from vaegan_tpu_torch.inference import latent_shape

    _check_platforms(platforms)
    size = image_size or cfg.data.image_size
    h, w, c = latent_shape(cfg, size)
    dev = next(state.generator.parameters()).device
    b = 2 if batch_size is None else int(batch_size)
    img = torch.zeros((b, size, size, cfg.generator.in_channels), device=dev)
    lat = torch.zeros((b, h, w, c), device=dev)
    inputs = {"reconstruct": img, "encode": img, "decode": lat}
    shapes = ({0: torch.export.Dim("b")},) if batch_size is None else None
    out = {}
    with torch.no_grad():
        for name, module in _entry_modules(cfg, state).items():
            ep = torch.export.export(module, (inputs[name],), dynamic_shapes=shapes)
            out[name] = move_to_device_pass(ep, "cpu")
    return out


def _shape(t) -> list:
    return [d if isinstance(d, int) else "b" for d in t.shape]


def _avals(ep: ExportedProgram):
    """(input fakes, output fakes) of the program's user inputs and outputs."""
    spec = ep.graph_signature
    nodes = {n.name: n for n in ep.graph.nodes}
    ins = [nodes[name].meta["val"] for name in spec.user_inputs]
    outs = [a.meta["val"] for a in ep.graph.output_node().args[0]]
    return ins, outs


def save_bundle(out_dir: str, cfg, state, *, image_size: Optional[int] = None,
                platforms: Sequence[str] = PLATFORMS,
                batch_size: Optional[int] = None) -> str:
    """Export and write a serving bundle; returns the manifest path."""
    from vaegan_tpu_torch.inference import latent_shape

    os.makedirs(out_dir, exist_ok=True)
    exported = export_entries(cfg, state, image_size=image_size, platforms=platforms,
                              batch_size=batch_size)
    entries = {}
    for name, ep in exported.items():
        fname = name + _ARTIFACT_SUFFIX
        torch.export.save(ep, os.path.join(out_dir, fname))
        ins, outs = _avals(ep)
        entries[name] = {"file": fname, "in_shapes": [_shape(t) for t in ins],
                         "in_dtypes": [str(t.dtype).removeprefix("torch.") for t in ins],
                         "out_shapes": [_shape(t) for t in outs]}
    size = image_size or cfg.data.image_size
    manifest = {
        "bundle_version": BUNDLE_VERSION,
        "platforms": list(platforms),
        "batch": "symbolic" if batch_size is None else int(batch_size),
        "image_size": size,
        "channels": cfg.generator.in_channels,
        "latent_shape": list(latent_shape(cfg, size)),
        "step": int(getattr(state, "step", 0)),
        "entries": entries,
        "config": cfg.to_dict(),
    }
    mpath = os.path.join(out_dir, MANIFEST_NAME)
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=2)
    return mpath


@dataclass(frozen=True)
class ServingBundle:
    """Loaded bundle: ``bundle.reconstruct(batch)``, ``.encode(batch)``,
    ``.decode(z)`` on ``device``; numpy arrays and tensors are taken, tensors
    returned. Needs only torch and ``ops.fused``: no model code."""

    manifest: dict
    programs: Dict[str, ExportedProgram]
    device: torch.device
    _calls: Dict[str, Callable] = field(init=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "_calls",
                           {name: ep.module() for name, ep in self.programs.items()})

    @property
    def image_size(self) -> int:
        return int(self.manifest["image_size"])

    @property
    def latent_shape(self) -> Tuple[int, int, int]:
        return tuple(self.manifest["latent_shape"])

    def _call(self, name: str, a):
        x = torch.as_tensor(a if isinstance(a, torch.Tensor) else np.asarray(a),
                            dtype=torch.float32, device=self.device)
        with torch.inference_mode(), ieee_float32():
            return self._calls[name](x)

    def reconstruct(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._call("reconstruct", batch)

    def encode(self, batch) -> torch.Tensor:
        return self._call("encode", batch)

    def decode(self, z) -> torch.Tensor:
        return self._call("decode", z)


def load_bundle(bundle_dir: str, device="cuda") -> ServingBundle:
    """Load a bundle's programs onto ``device`` (default ``"cuda"``, which
    raises without a card), one of the manifest's platforms."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    with open(os.path.join(bundle_dir, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    version = manifest.get("bundle_version", 0)
    if version > BUNDLE_VERSION:
        raise ValueError(f"bundle at {bundle_dir} has version {version}; this runtime "
                         f"supports <= {BUNDLE_VERSION}")
    if version < BUNDLE_VERSION:
        raise ValueError(f"bundle at {bundle_dir} has version {version} (a state_dict that "
                         "needed the model code to load); re-export it with save_bundle or "
                         "`cli export-serving`")
    if dev.type not in manifest["platforms"]:
        raise ValueError(f"bundle at {bundle_dir} was exported for {manifest['platforms']}, "
                         f"not for {dev.type}")
    programs = {name: move_to_device_pass(
        torch.export.load(os.path.join(bundle_dir, entry["file"])), dev)
        for name, entry in manifest["entries"].items()}
    return ServingBundle(manifest=manifest, programs=programs, device=dev)
