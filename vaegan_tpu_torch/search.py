"""Hyperparameter random search (port of ``vaegan_tpu/search.py``).

The reference's scheme, as the JAX package implements it:

- random configurations over depth / length / lr / loss-weight / n_critics /
  critic-shape grids, with the reference's monotonicity filters
  (``check_ascending``: critic feature lists ascend, stride lists do not
  descend);
- dedup against a persistent ``result/params.json`` registry, reserved under a
  file lock so concurrent searches never run one trial twice or drop each
  other's entries;
- each trial trains a (short) run with the port's ``train`` and evaluates the
  reconstruction MSE; its last sample grid is archived under the trial's UUID
  (``result/archive/<uuid>.png``);
- a failing trial (out of memory, a CUDA error, a shape error) is recorded as
  ``failed`` with its error, and the search goes on.

numpy's ``default_rng`` draws the parameters, so one seed draws the same trials
as the JAX package's search. Trials run on ``device`` (``"cuda"`` unless the
caller asks for the CPU).
"""

from __future__ import annotations

import json
import os
import shutil
import uuid
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from vaegan_tpu_torch.config import Config

# the reference's search grids
SEARCH_SPACE: Dict[str, List[Any]] = {
    "network_depth": [1, 2, 3],
    "network_length": [1, 2],
    "feature_size": [32, 64],
    "lr": [1e-4, 3e-4, 1e-3],
    "adversarial_loss_weight": [0.0, 0.5, 1.0],
    "reconstruction_loss_weight": [5.0, 10.0],
    "kl_weight": [0.01, 0.1],
    "n_critics": [1, 3, 5],
    "num_stride_conv1": [1, 2],
    "num_features_conv1": [32, 64],
    "num_blocks": [[1, 1, 1], [2, 2, 2], [1, 1]],
    "num_strides_res": [[1, 2, 2], [2, 2, 2], [1, 2]],
    "num_features_res": [[64, 128, 256], [128, 256, 512], [64, 128]],
}


def check_ascending(seq) -> bool:
    return all(a <= b for a, b in zip(seq, seq[1:]))


def is_valid(params: Dict[str, Any]) -> bool:
    """The reference's monotonicity and consistency filters."""
    nb, ns, nf = params["num_blocks"], params["num_strides_res"], params["num_features_res"]
    return len(nb) == len(ns) == len(nf) and check_ascending(nf) and check_ascending(ns)


def make_random_params(rng: np.random.Generator) -> Dict[str, Any]:
    while True:
        params = {k: v[rng.integers(len(v))] for k, v in SEARCH_SPACE.items()}
        params = {k: (list(v) if isinstance(v, (list, tuple)) else v) for k, v in params.items()}
        if is_valid(params):
            return params


def _load_registry(results_path) -> List[Dict[str, Any]]:
    p = Path(results_path)
    if p.exists():
        with open(p) as f:
            return json.load(f)
    return []


def _key(params: Dict[str, Any]) -> str:
    return json.dumps(params, sort_keys=True)


def check_already_done(params: Dict[str, Any], results_path) -> bool:
    key = _key(params)
    return any(_key(r.get("params", {})) == key for r in _load_registry(results_path))


def _locked_mutate(results_path, mutate) -> Any:
    """Run ``mutate(registry) -> result`` on the loaded registry under an
    ``flock`` on a sidecar file, then replace the file atomically, so
    concurrent searches cannot lose each other's read-modify-writes."""
    import fcntl

    p = Path(results_path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with open(str(p) + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            registry = _load_registry(p)
            result = mutate(registry)
            tmp = p.with_suffix(f".tmp{os.getpid()}")
            with open(tmp, "w") as f:
                json.dump(registry, f, indent=2)
            os.replace(tmp, p)
            return result
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def register_in_json(entry: Dict[str, Any], results_path) -> None:
    """Append ``entry`` to the registry, safely under concurrency."""
    _locked_mutate(results_path, lambda reg: reg.append(entry))


def register_if_new(entry: Dict[str, Any], results_path) -> bool:
    """Append ``entry`` only if no registry entry has the same params, checked
    and reserved under one lock; returns whether it was added."""
    key = _key(entry.get("params", {}))

    def mutate(registry):
        if any(_key(r.get("params", {})) == key for r in registry):
            return False
        registry.append(entry)
        return True

    return _locked_mutate(results_path, mutate)


def update_in_json(entry: Dict[str, Any], results_path) -> None:
    """Replace the registry entry with ``entry``'s id (append if missing)."""

    def mutate(registry):
        for i, r in enumerate(registry):
            if r.get("id") == entry.get("id"):
                registry[i] = entry
                return
        registry.append(entry)

    _locked_mutate(results_path, mutate)


def params_to_config(base: Config, params: Dict[str, Any]) -> Config:
    """``base`` with the searched fields replaced; every other field of the base
    (in_channels, is_vae, pool_size, feature_tap, ...) carries into the trial."""
    return base.replace(
        generator=base.generator.replace(
            depth=params["network_depth"], length=params["network_length"],
            feature_size=params["feature_size"]),
        discriminator=base.discriminator.replace(
            num_stride_conv1=params["num_stride_conv1"],
            num_features_conv1=params["num_features_conv1"],
            num_blocks=tuple(params["num_blocks"]),
            num_strides_res=tuple(params["num_strides_res"]),
            num_features_res=tuple(params["num_features_res"])),
        loss=base.loss.replace(
            adversarial_weight=params["adversarial_loss_weight"],
            reconstruction_weight=params["reconstruction_loss_weight"],
            kl_weight=params["kl_weight"]),
        optim=base.optim.replace(lr=params["lr"]),
        train=base.train.replace(n_critics=params["n_critics"]),
    )


def random_search(base: Config, n_trials: int, results_path="result/params.json",
                  archive_dir="result/archive", seed: int = 0,
                  max_steps_per_trial: Optional[int] = 200,
                  device="cuda") -> List[Dict[str, Any]]:
    """Run ``n_trials`` random configurations on ``device``; returns the registry
    entries added.

    ``max_steps_per_trial`` caps each trial's optimizer steps (through
    ``TrainConfig.max_steps``; ``None``: uncapped, the reference's full
    ``experiment()`` per trial). A dedup hit draws again instead of spending a
    trial; at most ``max(50, 20 * n_trials)`` draws are made."""
    from vaegan_tpu_torch import inference
    from vaegan_tpu_torch.data.pipeline import make_loader
    from vaegan_tpu_torch.train import loop

    rng = np.random.default_rng(seed)
    Path(archive_dir).mkdir(parents=True, exist_ok=True)
    added = []
    trial, draws = 0, 0
    max_draws = max(50, 20 * n_trials)
    while trial < n_trials and draws < max_draws:
        draws += 1
        params = make_random_params(rng)
        run_id = str(uuid.uuid4())
        entry: Dict[str, Any] = {"id": run_id, "params": params, "status": "pending"}
        if not register_if_new(entry, results_path):
            continue
        trial += 1
        try:
            cfg = params_to_config(base, params)
            # a sample folder of its own: train() wipes it at the start, and a
            # shared one would race concurrent searches
            t = cfg.train.replace(sample_dir=f"{cfg.train.sample_dir}_{run_id}")
            if max_steps_per_trial is not None:
                t = t.replace(max_steps=max_steps_per_trial if t.max_steps is None
                              else min(t.max_steps, max_steps_per_trial))
            cfg = cfg.replace(train=t)
            state, _ = loop.train(cfg, device=device)
            loader = make_loader(cfg.data, seed=cfg.train.seed, device=device)
            entry["recon_mse"] = inference.evaluate_mse(cfg, state, iter(loader))
            entry["status"] = "ok"
            sample_dir = Path(cfg.train.sample_dir)
            pngs = (sorted(sample_dir.glob("*.png"), key=lambda p: int(p.stem))
                    if sample_dir.exists() else [])
            if pngs:
                os.replace(pngs[-1], Path(archive_dir) / f"{run_id}.png")
            shutil.rmtree(sample_dir, ignore_errors=True)
        except Exception as e:  # out of memory, CUDA and shape errors: record, go on
            entry["status"] = "failed"
            entry["error"] = f"{type(e).__name__}: {e}"[:500]
        update_in_json(entry, results_path)
        added.append(entry)
        mse = entry.get("recon_mse")
        print(f"[search {trial}/{n_trials}] {entry['status']}"
              + (f" mse={mse:.4f}" if mse is not None else ""))
    return added
