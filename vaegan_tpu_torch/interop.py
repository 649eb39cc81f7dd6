"""Carry JAX-trained weights and train state into the port.

:func:`from_jax_variables` takes the JAX package's variables of a generator or a
critic (``{"params": ..., "batch_stats": ..., "spectral": ...}`` as nested dicts
of arrays) and returns the port's ``state_dict``, which is also the reference
notebook's ``UnsupervisedGeneratorNetwork`` / ``Discriminator`` layout.
:func:`load_jax_train_state` loads a whole JAX ``TrainState`` into the port's.
The rules are this package's own copy of those in ``vaegan_tpu/interop.py``
(variables -> torch ``state_dict``, :221-366):

- conv kernels HWIO (KH, KW, I, O) -> OIHW; transposed conv kernels -> (I, O, KH, KW),
  and only ``conv1`` and ``shortcut_conv`` of an upsample block are transposed
  (a square kernel's shape cannot tell);
- a kernel whose module has spectral (u, v) state is ``weight_orig``, and the
  vectors are ``weight_u``/``weight_v``;
- linear kernels (in, out) -> (out, in); the first one (``linear_1``) reads the
  critic's flattened pool map, which JAX flattens in (H, W, C) order and torch in
  (C, H, W) order, so its columns are permuted by ``pool_shape`` = (C, H, W);
- BN ``scale`` -> ``weight``, ``mean``/``var`` -> ``running_mean``/``running_var``,
  plus a ``num_batches_tracked`` of 0 per BN;
- ``shortcut_conv``/``shortcut_bn`` -> ``shortcut.0``/``shortcut.1``;
- ``encoder.*``/``decoder.*`` -> ``encoder.encoder.*``/``decoder.decoder.*``;
  ``res_layers_<i>_<j>`` -> ``res_layers.<i>.<j>``.

So ``load_state_dict(..., strict=True)`` takes both this function's output and the
``.pt`` that ``vaegan-tpu export`` writes. The same rules map any params-shaped
tree (gradients, RMSprop's ``nu``, Adam's ``mu`` and ``nu``) onto the port's
parameter names, given the critic's ``spectral`` tree beside it.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

_RES_LAYERS = re.compile(r"^res_layers_(\d+)_(\d+)(\.|$)")


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
    name = _RES_LAYERS.sub(lambda m: f"res_layers.{m.group(1)}.{m.group(2)}{m.group(3)}", name)
    for net in ("encoder", "decoder"):
        if name.startswith(net + "."):
            return f"{net}.{name}"
    return name


def _linear_weight(w: np.ndarray, pool_shape: Optional[Tuple[int, int, int]]) -> np.ndarray:
    w = w.T                                       # (in, out) -> (out, in)
    if pool_shape is not None:
        c, h, w_ = pool_shape                     # columns (H, W, C) -> (C, H, W)
        w = w.reshape(w.shape[0], h, w_, c).transpose(0, 3, 1, 2).reshape(w.shape[0], -1)
    return w


def from_jax_variables(variables: Mapping[str, Any],
                       pool_shape: Optional[Tuple[int, int, int]] = None
                       ) -> Dict[str, torch.Tensor]:
    """JAX generator or critic variables -> the port's ``state_dict`` (CPU
    tensors). ``pool_shape`` (C, H, W) is the critic's pooled map
    (``models.critic_pool_shape``); a tree with ``linear_1`` needs it."""
    params: Dict[Tuple[str, ...], np.ndarray] = {}
    stats: Dict[Tuple[str, ...], np.ndarray] = {}
    spec: Dict[Tuple[str, ...], np.ndarray] = {}
    _walk(variables.get("params", {}), (), params)
    _walk(variables.get("batch_stats", {}), (), stats)
    _walk(variables.get("spectral", {}), (), spec)
    sn_mods = {p[:-1] for p in spec}

    out: Dict[str, torch.Tensor] = {}
    for path, val in params.items():
        mod, leaf = path[:-1], path[-1]
        name = _module_name(mod)
        if leaf == "kernel" and val.ndim == 4:
            transposed = (any("upsample" in p for p in mod)
                          and mod[-1] in ("conv1", "shortcut_conv"))
            wname = "weight_orig" if mod in sn_mods else "weight"
            out[f"{name}.{wname}"] = _tensor(val.transpose((2, 3, 0, 1) if transposed
                                                           else (3, 2, 0, 1)))
        elif leaf == "kernel" and val.ndim == 2:
            first = mod[-1] == "linear_1"
            if first and pool_shape is None:
                raise ValueError(f"{name} reads the flattened pool map: pass pool_shape")
            out[f"{name}.weight"] = _tensor(_linear_weight(val, pool_shape if first else None))
        elif leaf == "scale":
            out[f"{name}.weight"] = _tensor(val)
        elif leaf == "bias":
            out[f"{name}.bias"] = _tensor(val)
        else:
            raise ValueError(f"unhandled params leaf {leaf!r} (shape {val.shape}) at {name}")
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
    for path, val in spec.items():
        mod, leaf = path[:-1], path[-1]
        if leaf not in ("u", "v"):
            raise ValueError(f"unhandled spectral leaf {leaf!r} at {'.'.join(mod)}")
        out[f"{_module_name(mod)}.weight_{leaf}"] = _tensor(val)
    return out


def _find_state(jopt, fields: Tuple[str, ...]):
    """The part of an optax state (a transformation's state, or a chain's tuple
    of them) that has every one of ``fields``; None if none has."""
    if all(hasattr(jopt, f) for f in fields):
        return jopt
    if isinstance(jopt, (tuple, list)):
        for part in jopt:
            found = _find_state(part, fields)
            if found is not None:
                return found
    return None


def _opt_trees(jopt, fields: Tuple[str, ...]):
    """``(count, {field: tree})`` of a JAX optimizer state: RMSprop's ``nu``, or
    Adam's ``mu`` and ``nu`` with its step ``count`` (``add_decayed_weights``
    before ``adam`` is a chain; the count is None for RMSprop). A
    three-optimizer ``opt_g = {"enc", "dec"}`` gives its two trees merged."""
    if isinstance(jopt, Mapping) and set(jopt) == {"enc", "dec"}:
        (count, enc), (_, dec) = _opt_trees(jopt["enc"], fields), _opt_trees(jopt["dec"], fields)
        return count, {f: {**enc[f], **dec[f]} for f in enc}
    found = _find_state(jopt, fields)
    if found is None:
        raise ValueError(f"load_jax_train_state: the JAX optimizer state has no {fields}")
    count = int(np.asarray(found.count)) if "count" in fields else None
    return count, {f: getattr(found, f) for f in fields if f != "count"}


# torch optimizer -> (fields of the JAX state, {torch state key: JAX field})
_OPT_STATE = {torch.optim.RMSprop: (("nu",), {"square_avg": "nu"}),
              torch.optim.Adam: (("count", "mu", "nu"), {"exp_avg": "mu", "exp_avg_sq": "nu"})}


def load_jax_train_state(state, jstate, pool_shape: Tuple[int, int, int]):
    """Load a JAX ``TrainState`` (any object with its fields: ``step``,
    ``g_params``, ``d_params``, ``g_stats``, ``d_stats``, ``d_spectral``,
    ``opt_g``, ``opt_d``, ``g_metrics``, ``g_ema``) into the port's
    ``train.TrainState``, in place; returns it. The optimizers must be RMSprop
    or Adam, as ``cfg.optim.optimizer`` builds them on both sides: RMSprop's
    ``nu`` becomes each parameter's ``square_avg`` (step: the state's step);
    optax Adam's ``(count, mu, nu)`` become torch Adam's ``step``, ``exp_avg``
    and ``exp_avg_sq``. A three-optimizer state's ``opt_g = {"enc", "dec"}``
    goes into the port's one ``opt_g``: the encoder's and the decoder's trees
    are merged."""
    gen, critic = state.generator, state.critic
    gen.load_state_dict(from_jax_variables(
        {"params": jstate.g_params, "batch_stats": jstate.g_stats}), strict=True)
    critic.load_state_dict(from_jax_variables(
        {"params": jstate.d_params, "batch_stats": jstate.d_stats,
         "spectral": jstate.d_spectral}, pool_shape), strict=True)
    step = int(np.asarray(jstate.step))
    for opt, module, jopt, spectral, pool in (
            (state.opt_g, gen, jstate.opt_g, {}, None),
            (state.opt_d, critic, jstate.opt_d, jstate.d_spectral, pool_shape)):
        kind = _OPT_STATE.get(type(opt))
        if kind is None:
            raise ValueError(f"load_jax_train_state carries RMSprop and Adam state, not "
                             f"{type(opt).__name__}")
        fields, keys = kind
        count, trees = _opt_trees(jopt, fields)
        # the spectral tree names the kernels that are ``weight_orig``
        torch_trees = {k: from_jax_variables({"params": trees[f], "spectral": spectral}, pool)
                       for k, f in keys.items()}
        n = step if count is None else count
        for name, p in module.named_parameters():
            opt.state[p] = {"step": torch.tensor(float(n)),
                            **{k: t[name].to(p.device) for k, t in torch_trees.items()}}
    dev = next(gen.parameters()).device
    state.step = step
    state.g_metrics = {k: torch.tensor(np.asarray(v), device=dev)
                       for k, v in jstate.g_metrics.items()}
    if jstate.g_ema is not None:
        ema = from_jax_variables({"params": jstate.g_ema})
        state.g_ema = {k: v.to(dev) for k, v in ema.items()}
    return state
