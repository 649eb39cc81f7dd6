"""The port's two-optimizer WGAN-GP train step against the JAX package's
``make_train_step``, on shared weights and shared random draws, over four steps
(G update on steps 0 and 2, critic only on 1 and 3), asserted after every step.

Two pairings: the port fused (``use_pallas="all"``: the five kernels' plain
versions on the CPU) against JAX ``"losses"`` (JAX refuses mask injection under
``"all"``), and ``"off"`` against ``"off"``. Draws: the port's fused steps draw
their own dropout seeds and reparameterization seed; their masks and noise are
rebuilt (``train.fused_draws``) and injected into the JAX step. The unfused
generator's masks and noise, the critic's ``Dropout2d`` masks and the GP alphas
are drawn here with numpy and injected into both.

Tolerances. Losses and metrics: 2e-4 relative (+1e-5 absolute); oneDNN and
XLA:CPU sum the convolutions in different orders. Gradients: within 1e-3 of
each tensor's largest gradient plus a share of the network's largest, 1e-5 for
the generator and 1e-2 for the critic: a gradient that is a sum of cancelling
terms (a BN scale whose channel's terms cancel, or any critic gradient once the
clamp has pinned the weights at ±0.01 and the gradients shrink to ~1e-4) carries
float32 noise on the scale of its terms, not of its value. ``sqrt(square_avg)``: 1e-3 relative plus 0.1 of the
gradient tolerance (it is an RMS of gradients weighted by 1 - alpha = 0.01). Parameters: 1e-5 absolute + 1e-4 relative where the
recorded gradient is above the noise floor, 2e-3 of the tensor's largest
gradient; below it, a first RMSprop step moves a parameter by about
10 * lr * sign(g) and a sign at cancellation scale is noise, so those elements
are only held to the update bound (2.5 * 10 * lr per update so far). BN running
statistics 1e-4; spectral u and v 1e-3, or 5e-2 where noise decided part of
their weight's updates (the critic's first block here: its weights sit at
±0.01 after the first clamp, and its gradients at ~1e-7); the generator EMA
1e-4 relative.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import vaegan_tpu.train.state as jstate_mod
import vaegan_tpu.train.step as jstep_mod
from vaegan_tpu import interop as jinterop
from vaegan_tpu.config import preset as jpreset
import vaegan_tpu_torch as vt
from vaegan_tpu_torch.interop import from_jax_variables
from vaegan_tpu_torch.train import fused_draws, make_train_step

SIZE, BATCH, LR = 32, 2, 3e-4
G_STEPS = (True, False, True, False)
MODES = {"all-vs-losses": ("all", "losses"), "off-vs-off": ("off", "off")}


def configs(port_mode: str, jax_mode: str):
    jcfg = jpreset("notebook")
    jcfg = jcfg.replace(
        generator=jcfg.generator.replace(depth=1, length=1, feature_size=4),
        discriminator=jcfg.discriminator.replace(
            num_features_conv1=8, num_blocks=(1, 1), num_strides_res=(1, 2),
            num_features_res=(8, 16), linear_widths=(16, 8)),
        data=jcfg.data.replace(image_size=SIZE, batch_size=BATCH),
        train=jcfg.train.replace(use_pallas=jax_mode, ema_decay=0.999))
    cfg = vt.Config.from_dict(jcfg.to_dict())
    return jcfg, cfg.replace(train=cfg.train.replace(use_pallas=port_mode))


class GradRec(NamedTuple):
    inner: Any
    grads: Any


def _recording(tx):
    """An optax transformation that keeps the last raw gradients in its state."""
    def init(params):
        return GradRec(tx.init(params), jax.tree.map(jnp.zeros_like, params))

    def update(g, s, params=None):
        u, inner = tx.update(g, s.inner, params)
        return u, GradRec(inner, g)

    return optax.GradientTransformation(init, update)


def _record_port(opt, module, store):
    named = list(module.named_parameters())
    inner = opt.step

    def step(*a, **k):
        store.clear()
        store.update({n: p.grad.detach().clone() for n, p in named})
        return inner(*a, **k)

    opt.step = step


def _masks_collection(masks: dict, kind: str):
    pairs = [(k, np.asarray(v.detach().cpu().numpy(), np.float32)) for k, v in masks.items()]
    return jax.tree.map(jnp.asarray, jinterop.reference_dropout_masks_to_collection(pairs, kind))


def _numpy_critic_masks(critic, rng):
    """A channel keep-mask (B, C, 1, 1) for each critic Dropout2d (after conv1)."""
    out = {}
    for name, m in critic.named_modules():
        if isinstance(m, vt.models.ResBlockDiscriminator):
            c = m.conv1.weight_orig.shape[0]
            out[f"{name}.dropout"] = torch.from_numpy(rng.random((BATCH, c, 1, 1)) >= 0.5)
    return out


@functools.lru_cache(maxsize=None)
def trajectory(mode: str):
    """Run both steps four times; returns per-step (port, jax) records."""
    port_mode, jax_mode = MODES[mode]
    jcfg, cfg = configs(port_mode, jax_mode)
    mp = pytest.MonkeyPatch()
    try:
        for mod in (jstep_mod, jstate_mod):
            orig = mod.build_optimizer
            mp.setattr(mod, "build_optimizer",
                       lambda c, role=None, _o=orig: _recording(_o(c, role)))
        jstate = jstate_mod.create_train_state(jcfg, jax.random.key(0))
        jsteps = {g: jax.jit(lambda s, b, inj, g=g: jstep_mod.make_train_step(
            jcfg, g, inject=inj)(s, b, jax.random.key(1))) for g in (True, False)}
        state = vt.create_train_state(cfg, device="cpu")
        pool = state.critic.pool_shape
        vt.load_jax_train_state(state, jstate.replace(
            opt_g=jstate.opt_g.inner, opt_d=jstate.opt_d.inner), pool)
        g_rec, d_rec = {}, {}
        _record_port(state.opt_g, state.generator, g_rec)
        _record_port(state.opt_d, state.critic, d_rec)
        rng = np.random.default_rng(7)
        records = []
        for i, do_g in enumerate(G_STEPS):
            batch = rng.random((BATCH, SIZE, SIZE, 1), dtype=np.float32)
            inj = {f"d_masks_{k}": _numpy_critic_masks(state.critic, rng)
                   for k in ("real", "fake", "interp", "gen")}
            inj["alpha"] = torch.from_numpy(rng.random(BATCH).astype(np.float32))
            if port_mode == "off":
                inj["eps"] = torch.from_numpy(
                    rng.standard_normal((BATCH, SIZE // 2, SIZE // 2, 8)).astype(np.float32))
                inj["g_masks"] = {name: torch.from_numpy(rng.random(shape) >= 0.5)
                                  for name, shape in _gen_mask_shapes(state.generator)}
            if not do_g:
                inj.pop("d_masks_gen")
            step = make_train_step(cfg, do_g, inject=inj)
            state, metrics = step(state, torch.from_numpy(batch), 100 + i)
            jinj = dict(inj)
            if port_mode == "all":
                jinj.update(fused_draws(state.generator))
            jinj = {k: (_masks_collection(v, "discriminator" if k.startswith("d_") else
                                          "generator") if "masks" in k else
                        jnp.asarray(np.asarray(v))) for k, v in jinj.items()}
            jstate, jmetrics = jsteps[do_g](jstate, jnp.asarray(batch), jinj)
            records.append(dict(
                do_g=do_g, metrics={k: float(v) for k, v in metrics.items()},
                jmetrics={k: float(v) for k, v in jmetrics.items()},
                g_grads=dict(g_rec) if do_g else None, d_grads=dict(d_rec),
                jg_grads=(from_jax_variables({"params": jstate.opt_g.grads})
                          if do_g else None),
                jd_grads=_params_tree(jstate.opt_d.grads, jstate.d_spectral, pool),
                gen=_sd(state.generator), critic=_sd(state.critic),
                jgen=from_jax_variables({"params": jstate.g_params,
                                         "batch_stats": jstate.g_stats}),
                jcritic=from_jax_variables({"params": jstate.d_params,
                                            "batch_stats": jstate.d_stats,
                                            "spectral": jstate.d_spectral}, pool),
                nu_g=_nu(state.opt_g, state.generator), nu_d=_nu(state.opt_d, state.critic),
                jnu_g=from_jax_variables({"params": jstate.opt_g.inner.nu}),
                jnu_d=_params_tree(jstate.opt_d.inner.nu, jstate.d_spectral, pool),
                ema={k: v.clone() for k, v in state.g_ema.items()},
                jema=from_jax_variables({"params": jstate.g_ema}),
                g_updates=sum(G_STEPS[:i + 1])))
        return records
    finally:
        mp.undo()


def _gen_mask_shapes(gen):
    """{Dropout module path: NCHW input shape} of an unfused generator, from one
    eval forward (an eval Dropout passes its input through, and is still called)."""
    shapes = {}
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, name=name: shapes.__setitem__(name, tuple(inp[0].shape)))
        for name, m in gen.named_modules() if isinstance(m, vt.models.Dropout)]
    with torch.no_grad():
        gen(torch.zeros(BATCH, SIZE, SIZE, 1), train=False)
    for h in hooks:
        h.remove()
    return shapes.items()


def _params_tree(tree, spectral, pool):
    """A params-shaped JAX tree of the critic under the port's parameter names."""
    sd = from_jax_variables({"params": tree, "spectral": spectral}, pool)
    return {k: v for k, v in sd.items() if not k.endswith(("weight_u", "weight_v"))}


def _sd(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _nu(opt, module):
    return {n: opt.state[p]["square_avg"].clone() for n, p in module.named_parameters()}


def _close(got, want, what, rtol, atol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bad = np.abs(got - want) > atol + rtol * np.abs(want)
    assert not bad.any(), (f"{what}: {int(bad.sum())}/{bad.size} out of tolerance, "
                           f"max |diff| {np.abs(got - want).max():.3e}")


def _grad_tol(want: dict, share: float) -> dict:
    net = max(float(w.abs().max()) for w in want.values())
    return {k: 1e-3 * float(w.abs().max()) + share * net for k, w in want.items()}


def _noisy_elements(mode: str, i: int, net: str, share: float) -> dict:
    """Per parameter, the elements whose gradient was within the gradient
    tolerance of zero at some update up to step ``i``: their RMSprop state and
    updates carry a direction that float32 noise decides."""
    noisy = {}
    for rec in trajectory(mode)[:i + 1]:
        want = rec[f"j{net}_grads"]
        if want is None:
            continue
        tol = _grad_tol(want, share)
        for k, w in want.items():
            now = np.abs(w.numpy()) <= tol[k]
            noisy[k] = now | noisy.get(k, False)
    return noisy


def _max_grad_tol(mode: str, i: int, net: str, share: float) -> dict:
    """Per parameter, the largest gradient tolerance of the updates up to step i."""
    out = {}
    for rec in trajectory(mode)[:i + 1]:
        if rec[f"j{net}_grads"] is not None:
            for k, v in _grad_tol(rec[f"j{net}_grads"], share).items():
                out[k] = max(v, out.get(k, 0.0))
    return out


CASES = [(m, i) for m in MODES for i in range(len(G_STEPS))]


@pytest.mark.parametrize("mode,i", CASES, ids=[f"{m}-step{i}" for m, i in CASES])
def test_step_matches_jax(mode, i):
    r = trajectory(mode)[i]
    assert set(r["metrics"]) == set(r["jmetrics"])
    for k, want in r["jmetrics"].items():
        _close(r["metrics"][k], want, f"metric {k}", 2e-4, 1e-5)

    def grads_close(got, want, what, share):
        assert set(got) == set(want), what
        tol = _grad_tol(want, share)
        for k, w in want.items():
            _close(got[k].numpy(), w.numpy(), f"{what} {k}", 0.0, tol[k])

    grads_close(r["d_grads"], r["jd_grads"], "critic grad", 1e-2)
    if r["do_g"]:
        grads_close(r["g_grads"], r["jg_grads"], "generator grad", 1e-5)

    for net, gkey, share in (("gen", "g", 1e-5), ("critic", "d", 1e-2)):
        got, want = r[net], r["j" + net]
        noisy = _noisy_elements(mode, i, gkey, share)
        n_updates = r["g_updates"] if net == "gen" else i + 1
        for k, w in want.items():
            g = got[k]
            if k.endswith(("running_mean", "running_var")):
                _close(g.numpy(), w.numpy(), f"{net} {k}", 1e-4, 1e-4)
            elif k.endswith(("weight_u", "weight_v")):
                # u and v follow W; where float32 noise decided some of W's
                # updates, they follow a slightly different W
                w_noisy = noisy.get(k.rsplit(".", 1)[0] + ".weight_orig", np.False_).any()
                _close(g.numpy(), w.numpy(), f"{net} {k}", 0.0, 5e-2 if w_noisy else 1e-3)
            elif not k.endswith("num_batches_tracked"):
                tol = 1e-5 + 1e-4 * np.abs(w.numpy())
                tol = np.where(noisy[k], np.maximum(tol, 2.5 * 10 * LR * n_updates), tol)
                diff = np.abs(g.numpy() - w.numpy())
                assert (diff <= tol).all(), f"{net} {k}: max |diff| {diff.max():.3e}"

    for net, share in (("g", 1e-5), ("d", 1e-2)):
        got, want = r[f"nu_{net}"], r[f"jnu_{net}"]
        gtol = _max_grad_tol(mode, i, net, share)
        for k, w in want.items():
            # sqrt(square_avg) is an RMS of 0.1-weighted gradients: it inherits
            # 0.1 of the gradient tolerance
            _close(got[k].sqrt().numpy(), w.sqrt().numpy(), f"sqrt(square_avg) {net} {k}",
                   1e-3, 0.1 * gtol[k] + 1e-12)

    for k, w in r["jema"].items():
        _close(r["ema"][k].numpy(), w.numpy(), f"ema {k}", 1e-4,
               1e-5 + 2.5 * 10 * LR * r["g_updates"] * 1e-3)
