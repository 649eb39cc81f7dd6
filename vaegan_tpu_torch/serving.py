"""Serving bundles (port of ``vaegan_tpu/serving.py``).

A bundle is a directory with a ``manifest.json`` (the JAX bundle's fields:
bundle_version, image_size, channels, latent_shape, entries, config, plus the
weights file) and the generator's ``state_dict`` saved with ``torch.save``.
:func:`load_bundle` rebuilds the generator from the manifest's config, loads the
weights with ``strict=True`` and serves eval-mode ``reconstruct`` / ``encode`` /
``decode`` on the requested device, any batch size.

The JAX bundle forced ``use_pallas="off"`` because Mosaic kernels have no CPU
lowering; here the config's ``use_pallas`` is honoured (the fused kernel on a
CUDA device, its plain version on the CPU).

Layout::

    out_dir/
      manifest.json
      generator.pt       # state_dict: (b, H, W, C) -> reconstruct / encode, (b, h, w, C') -> decode
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from vaegan_tpu_torch.config import Config
from vaegan_tpu_torch.inference import _as_input, eval_reconstruct, latent_shape
from vaegan_tpu_torch.models import UnsupervisedGeneratorNetwork
from vaegan_tpu_torch.train.state import GeneratorState, build_generator, resolve_device

MANIFEST_NAME = "manifest.json"
WEIGHTS_NAME = "generator.pt"
BUNDLE_VERSION = 1


def save_bundle(out_dir: str, cfg: Config, state: GeneratorState,
                image_size: Optional[int] = None) -> str:
    """Write a serving bundle; returns the manifest path."""
    os.makedirs(out_dir, exist_ok=True)
    size = image_size or cfg.data.image_size
    c = cfg.generator.in_channels
    lat = list(latent_shape(cfg, size))
    img = ["b", size, size, c]
    entries = {
        "reconstruct": {"in_shapes": [img], "in_dtypes": ["float32"],
                        "out_shapes": [img, []]},
        "encode": {"in_shapes": [img], "in_dtypes": ["float32"],
                   "out_shapes": [["b"] + lat]},
        "decode": {"in_shapes": [["b"] + lat], "in_dtypes": ["float32"],
                   "out_shapes": [img]},
    }
    sd = {k: v.detach().cpu() for k, v in state.generator.state_dict().items()}
    torch.save(sd, os.path.join(out_dir, WEIGHTS_NAME))
    manifest = {
        "bundle_version": BUNDLE_VERSION,
        "batch": "symbolic",
        "image_size": size,
        "channels": c,
        "latent_shape": lat,
        "step": int(state.step),
        "weights": WEIGHTS_NAME,
        "entries": entries,
        "config": cfg.to_dict(),
    }
    mpath = os.path.join(out_dir, MANIFEST_NAME)
    with open(mpath, "w") as f:
        json.dump(manifest, f, indent=2)
    return mpath


@dataclass(frozen=True)
class ServingBundle:
    """Loaded bundle: ``bundle.reconstruct(batch)``, ``.encode(batch)``, ``.decode(z)``."""

    manifest: dict
    cfg: Config
    generator: UnsupervisedGeneratorNetwork
    device: torch.device

    @property
    def image_size(self) -> int:
        return int(self.manifest["image_size"])

    @property
    def latent_shape(self) -> Tuple[int, int, int]:
        return tuple(self.manifest["latent_shape"])

    def reconstruct(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        return eval_reconstruct(self.cfg, self.generator, _as_input(batch, self.device))

    @torch.inference_mode()
    def encode(self, batch) -> torch.Tensor:
        return self.generator.encode(_as_input(batch, self.device))

    @torch.inference_mode()
    def decode(self, z) -> torch.Tensor:
        return self.generator.decode(_as_input(z, self.device))


def load_bundle(bundle_dir: str, device="cuda") -> ServingBundle:
    dev = resolve_device(device)
    with open(os.path.join(bundle_dir, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    if manifest.get("bundle_version", 0) > BUNDLE_VERSION:
        raise ValueError(
            f"bundle at {bundle_dir} has version {manifest['bundle_version']}; "
            f"this runtime supports <= {BUNDLE_VERSION}")
    cfg = Config.from_dict(manifest["config"])
    gen = build_generator(cfg, dev)
    sd = torch.load(os.path.join(bundle_dir, manifest["weights"]), map_location=dev,
                    weights_only=True)
    gen.load_state_dict(sd, strict=True)
    return ServingBundle(manifest=manifest, cfg=cfg, generator=gen, device=dev)
