"""Carry JAX-trained generator weights into the port.

:func:`from_jax_variables` takes the JAX package's generator variables
(``{"params": ..., "batch_stats": ...}`` as nested dicts of arrays) and returns
the port's generator ``state_dict``, which is also the reference notebook's
``UnsupervisedGeneratorNetwork.state_dict()`` layout. The rules are this
package's own copy of those in ``vaegan_tpu/interop.py`` (variables -> torch
``state_dict``, :221-342):

- conv kernels HWIO (KH, KW, I, O) -> OIHW; transposed conv kernels -> (I, O, KH, KW),
  and only ``conv1`` and ``shortcut_conv`` of an upsample block are transposed
  (a square kernel's shape cannot tell);
- BN ``scale`` -> ``weight``, ``mean``/``var`` -> ``running_mean``/``running_var``,
  plus a ``num_batches_tracked`` of 0 per BN;
- ``shortcut_conv``/``shortcut_bn`` -> ``shortcut.0``/``shortcut.1``;
- ``encoder.*``/``decoder.*`` -> ``encoder.encoder.*``/``decoder.decoder.*``.

So ``load_state_dict(..., strict=True)`` takes both this function's output and the
``.pt`` that ``vaegan-tpu export`` writes.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch


def _walk(tree: Mapping[str, Any], path: Tuple[str, ...], out: Dict[Tuple[str, ...], np.ndarray]) -> None:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            _walk(v, path + (k,), out)
        else:
            out[path + (k,)] = np.asarray(v)


def _tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def _module_name(mod: Tuple[str, ...]) -> str:
    name = ".".join(mod).replace("shortcut_conv", "shortcut.0").replace("shortcut_bn", "shortcut.1")
    for net in ("encoder", "decoder"):
        if name.startswith(net + "."):
            return f"{net}.{name}"
    return name


def from_jax_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX generator variables -> the port's generator ``state_dict`` (CPU tensors)."""
    params: Dict[Tuple[str, ...], np.ndarray] = {}
    stats: Dict[Tuple[str, ...], np.ndarray] = {}
    _walk(variables.get("params", {}), (), params)
    _walk(variables.get("batch_stats", {}), (), stats)

    out: Dict[str, torch.Tensor] = {}
    for path, val in params.items():
        mod, leaf = path[:-1], path[-1]
        name = _module_name(mod)
        if leaf == "kernel":
            if val.ndim != 4:
                raise ValueError(f"unexpected kernel rank for {name}: {val.shape}")
            transposed = (any("upsample" in p for p in mod)
                          and mod[-1] in ("conv1", "shortcut_conv"))
            out[f"{name}.weight"] = _tensor(val.transpose((2, 3, 0, 1) if transposed
                                                          else (3, 2, 0, 1)))
        elif leaf == "scale":
            out[f"{name}.weight"] = _tensor(val)
        elif leaf == "bias":
            out[f"{name}.bias"] = _tensor(val)
        else:
            raise ValueError(f"unhandled params leaf {leaf!r} at {name}")
    bn_mods = set()
    for path, val in stats.items():
        mod, leaf = path[:-1], path[-1]
        key = {"mean": "running_mean", "var": "running_var"}.get(leaf)
        if key is None:
            raise ValueError(f"unhandled batch_stats leaf {leaf!r} at {'.'.join(mod)}")
        name = _module_name(mod)
        out[f"{name}.{key}"] = _tensor(val)
        bn_mods.add(name)
    for name in bn_mods:
        out[f"{name}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
    return out
