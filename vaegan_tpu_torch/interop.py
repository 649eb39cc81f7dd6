"""Carry JAX-trained weights and train state into the port.

:func:`from_jax_variables` takes the JAX package's variables of a generator or a
critic (``{"params": ..., "batch_stats": ..., "spectral": ...}`` as nested dicts
of arrays) and returns the port's ``state_dict``, which is also the reference
notebook's ``UnsupervisedGeneratorNetwork`` / ``Discriminator`` layout.
:func:`load_jax_train_state` loads a whole JAX ``TrainState`` into the port's, and
:func:`jax_train_state_payload` gives it as a port checkpoint's payload (how
``checkpoint.CheckpointManager`` restores an Orbax step).
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


def _has(state, name: str) -> bool:
    return name in state if isinstance(state, Mapping) else hasattr(state, name)


def _field(state, name: str):
    return state[name] if isinstance(state, Mapping) else getattr(state, name)


def _find_state(jopt, fields: Tuple[str, ...]):
    """The part of an optax state (a transformation's state, or a chain's tuple
    of them) that has every one of ``fields``; None if none has. A state read
    from an Orbax checkpoint has mappings where optax has namedtuples and lists
    where it has tuples (``orbax_reader.read_tree``)."""
    if jopt is not None and all(_has(jopt, f) for f in fields):
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
    count = int(np.asarray(_field(found, "count"))) if "count" in fields else None
    return count, {f: _field(found, f) for f in fields if f != "count"}


# torch optimizer -> (fields of the JAX state, {torch state key: JAX field})
_OPT_STATE = {torch.optim.RMSprop: (("nu",), {"square_avg": "nu"}),
              torch.optim.Adam: (("count", "mu", "nu"), {"exp_avg": "mu", "exp_avg_sq": "nu"})}


def jax_train_state_payload(state, jstate, pool_shape: Tuple[int, int, int]) -> dict:
    """A JAX ``TrainState`` (any object with its fields: ``step``, ``g_params``,
    ``d_params``, ``g_stats``, ``d_stats``, ``d_spectral``, ``opt_g``,
    ``opt_d``, ``g_metrics``, ``g_ema``; or a mapping of them) as the payload of
    a port checkpoint (``checkpoint.CheckpointManager``'s ``<step>.pt``) for
    ``state``'s modules and optimizers: CPU tensors, whole critic kernels. The
    optimizers must be RMSprop or Adam, as ``cfg.optim.optimizer`` builds them on
    both sides: RMSprop's ``nu`` becomes each parameter's ``square_avg`` (step:
    the state's step); optax Adam's ``(count, mu, nu)`` become torch Adam's
    ``step``, ``exp_avg`` and ``exp_avg_sq``. A three-optimizer state's ``opt_g =
    {"enc", "dec"}`` goes into the port's one ``opt_g``: the encoder's and the
    decoder's trees are merged."""
    get = (lambda k: jstate[k]) if isinstance(jstate, Mapping) else (lambda k: getattr(jstate, k))
    gen_sd = from_jax_variables({"params": get("g_params"), "batch_stats": get("g_stats")})
    critic_sd = from_jax_variables({"params": get("d_params"), "batch_stats": get("d_stats"),
                                    "spectral": get("d_spectral")}, pool_shape)
    step = int(np.asarray(get("step")))
    payload = {"step": step, "generator": gen_sd, "critic": critic_sd}
    for key, module, jopt, spectral, pool in (
            ("opt_g", state.generator, get("opt_g"), {}, None),
            ("opt_d", state.critic, get("opt_d"), get("d_spectral"), pool_shape)):
        opt = getattr(state, key)
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
        index = {id(p): i for i, p in enumerate(p for g in opt.param_groups for p in g["params"])}
        payload[key] = {
            "state": {index[id(p)]: {"step": torch.tensor(float(n)),
                                     **{k: t[name] for k, t in torch_trees.items()}}
                      for name, p in module.named_parameters()},
            "param_groups": opt.state_dict()["param_groups"]}
    payload["g_metrics"] = {k: torch.tensor(np.asarray(v)) for k, v in get("g_metrics").items()}
    ema = get("g_ema")
    payload["g_ema"] = None if ema is None else from_jax_variables({"params": ema})
    return payload


def load_jax_train_state(state, jstate, pool_shape: Tuple[int, int, int]):
    """Load a JAX ``TrainState`` into the port's ``train.TrainState``, in place
    (:func:`jax_train_state_payload` says how); returns it. Its generator EMA,
    where it has one, replaces the state's."""
    payload = jax_train_state_payload(state, jstate, pool_shape)
    state.generator.load_state_dict(payload["generator"], strict=True)
    state.critic.load_state_dict(payload["critic"], strict=True)
    state.opt_g.load_state_dict(payload["opt_g"])
    state.opt_d.load_state_dict(payload["opt_d"])
    dev = next(state.generator.parameters()).device
    state.step = payload["step"]
    state.g_metrics = {k: v.to(dev) for k, v in payload["g_metrics"].items()}
    if payload["g_ema"] is not None:
        state.g_ema = {k: v.to(dev) for k, v in payload["g_ema"].items()}
    return state
