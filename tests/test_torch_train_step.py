"""The port's two-optimizer WGAN-GP train step against the JAX package's
``make_train_step``, on shared weights and shared random draws, over four steps
(G update on steps 0 and 2, critic only on 1 and 3), asserted after every step.
The same comparison holds ``gan_only`` (BCE), ``vae_96`` (no adversarial
loss) and a lazy-GP schedule's four variants at lr_d = 0
(:func:`test_other_steps_match_jax`).

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

# the suite runs files in parallel workers; one intra-op thread each keeps
# torch from taking every core from the other workers
torch.set_num_threads(1)

SIZE, BATCH, LR = 32, 2, 3e-4
G_STEPS = (True, False, True, False)
MODES = {"all-vs-losses": ("all", "losses"), "off-vs-off": ("off", "off")}
# (do_g_update, do_gp, gp_lambda_scale) of each step
PLAN = tuple((g, True, 1.0) for g in G_STEPS)
# every (do_g_update, do_gp) variant a lazy-GP schedule builds, at gp_every 2
LAZY_PLAN = ((True, True, 2.0), (False, False, 2.0), (True, False, 2.0), (False, True, 2.0))


class Case(NamedTuple):
    preset: str
    plan: tuple
    lr_d: Any = None      # None: the preset's


# the notebook step as the loop runs it, and (at lr_d = 0, the critic held
# still) the other losses and the lazy-GP variants: see test_other_steps_match_jax
CASES = {
    "notebook": Case("notebook", PLAN),
    "gan_only": Case("gan_only", PLAN[:2], 0.0),
    "vae_96": Case("vae_96", PLAN, 0.0),
    "lazy_gp": Case("notebook", LAZY_PLAN, 0.0),
}


def configs(port_mode: str, jax_mode: str, case: str = "notebook"):
    c = CASES[case]
    jcfg = jpreset(c.preset)
    if c.preset != "vae_96":   # vae_96's one-feature dummy critic is narrow already
        jcfg = jcfg.replace(discriminator=jcfg.discriminator.replace(
            num_features_conv1=8, num_blocks=(1, 1), num_strides_res=(1, 2),
            num_features_res=(8, 16), linear_widths=(16, 8)))
    jcfg = jcfg.replace(
        generator=jcfg.generator.replace(depth=1, length=1, feature_size=4),
        data=jcfg.data.replace(image_size=SIZE, batch_size=BATCH),
        train=jcfg.train.replace(use_pallas=jax_mode, ema_decay=0.999))
    if c.lr_d is not None:
        jcfg = jcfg.replace(optim=jcfg.optim.replace(lr_d=c.lr_d))
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


def _numpy_critic_masks(critic, rng, batch=BATCH):
    """A channel keep-mask (B, C, 1, 1) for each critic Dropout2d (after conv1)."""
    out = {}
    for name, m in critic.named_modules():
        if isinstance(m, vt.models.ResBlockDiscriminator):
            c = m.conv1.weight_orig.shape[0]
            out[f"{name}.dropout"] = torch.from_numpy(rng.random((batch, c, 1, 1)) >= 0.5)
    return out


@functools.lru_cache(maxsize=None)
def trajectory(mode: str, case: str = "notebook"):
    """Run both steps through the case's plan; returns per-step (port, jax)
    records."""
    port_mode, jax_mode = MODES[mode]
    jcfg, cfg = configs(port_mode, jax_mode, case)
    plan = CASES[case].plan
    mp = pytest.MonkeyPatch()
    try:
        for mod in (jstep_mod, jstate_mod):
            orig = mod.build_optimizer
            mp.setattr(mod, "build_optimizer",
                       lambda c, role=None, _o=orig: _recording(_o(c, role)))
        jstate = jstate_mod.create_train_state(jcfg, jax.random.key(0))
        jsteps = {v: jax.jit(lambda s, b, inj, v=v: jstep_mod.make_train_step(
            jcfg, v[0], inject=inj, do_gp=v[1], gp_lambda_scale=v[2])(
                s, b, jax.random.key(1))) for v in set(plan)}
        state = vt.create_train_state(cfg, device="cpu")
        pool = state.critic.pool_shape
        vt.load_jax_train_state(state, jstate.replace(
            opt_g=jstate.opt_g.inner, opt_d=jstate.opt_d.inner), pool)
        g_rec, d_rec = {}, {}
        _record_port(state.opt_g, state.generator, g_rec)
        _record_port(state.opt_d, state.critic, d_rec)
        rng = np.random.default_rng(7)
        records = []
        for i, (do_g, do_gp, scale) in enumerate(plan):
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
            step = make_train_step(cfg, do_g, inject=inj, do_gp=do_gp, gp_lambda_scale=scale)
            state, metrics = step(state, torch.from_numpy(batch), 100 + i)
            jinj = dict(inj)
            if port_mode == "all":
                jinj.update(fused_draws(state.generator))
            jinj = {k: (_masks_collection(v, "discriminator" if k.startswith("d_") else
                                          "generator") if "masks" in k else
                        jnp.asarray(np.asarray(v))) for k, v in jinj.items()}
            jstate, jmetrics = jsteps[(do_g, do_gp, scale)](jstate, jnp.asarray(batch), jinj)
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
                g_updates=sum(g for g, _, _ in plan[:i + 1])))
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


def _noisy_elements(mode: str, i: int, net: str, share: float, case: str) -> dict:
    """Per parameter, the elements whose gradient was within the gradient
    tolerance of zero at some update up to step ``i``: their RMSprop state and
    updates carry a direction that float32 noise decides."""
    noisy = {}
    for rec in trajectory(mode, case)[:i + 1]:
        want = rec[f"j{net}_grads"]
        if want is None:
            continue
        tol = _grad_tol(want, share)
        for k, w in want.items():
            now = np.abs(w.numpy()) <= tol[k]
            noisy[k] = now | noisy.get(k, False)
    return noisy


def _max_grad_tol(mode: str, i: int, net: str, share: float, case: str) -> dict:
    """Per parameter, the largest gradient tolerance of the updates up to step i."""
    out = {}
    for rec in trajectory(mode, case)[:i + 1]:
        if rec[f"j{net}_grads"] is not None:
            for k, v in _grad_tol(rec[f"j{net}_grads"], share).items():
                out[k] = max(v, out.get(k, 0.0))
    return out


NOTEBOOK_STEPS = [(m, i) for m in MODES for i in range(len(G_STEPS))]
OTHER_STEPS = [(c, m, i) for c in CASES if c != "notebook" for m in MODES
               for i in range(len(CASES[c].plan))]


@pytest.mark.parametrize("mode,i", NOTEBOOK_STEPS, ids=[f"{m}-step{i}" for m, i in NOTEBOOK_STEPS])
def test_step_matches_jax(mode, i):
    check_step(mode, i, "notebook")


@pytest.mark.parametrize("case,mode,i", OTHER_STEPS,
                         ids=[f"{c}-{m}-step{i}" for c, m, i in OTHER_STEPS])
def test_other_steps_match_jax(case, mode, i):
    """The BCE loss (``gan_only``), no adversarial loss (``vae_96``) and the
    lazy-GP variants (no penalty, and λ scaled by 2 where it runs) at lr_d = 0,
    the critic held still: with the critic moving, a clamp-pinned critic
    gradient of ~1e-5 parts by ~1e-7 absolute, over this file's tolerance.

    ``gan_only`` stops after its first G and critic steps: its next G step
    (the second G update) has a kink on this trajectory (:func:`gan_only_kink`
    prints the numbers, CPU). In the unfused pairing, one LeakyReLU
    pre-activation of the decoder's last block (``bn1``, channel 3) is
    +3.7e-6 in JAX and -3.5e-6 in the port: float32 summation order puts it on
    either side of 0, and the generator gradients part by 2.06e-2 of the net's
    largest, 2062 times this file's 1e-5. Each package run from the other's
    state after step 1 lands on its own side (within 6.1e-7 of its own run),
    and each parts from itself alike under noise: 1 + 1e-7 batch noise 8.0e-7
    (JAX) and 7.5e-7 (port), 1e-6 parameter noise 1.2e-5 and 1.2e-5, 1e-5
    parameter noise 2.4e-2 and 3.4e-3. Past that point the comparison
    measures where the kink falls, not the port."""
    check_step(mode, i, case)


def check_step(mode, i, case):
    r = trajectory(mode, case)[i]
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
        noisy = _noisy_elements(mode, i, gkey, share, case)
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
        gtol = _max_grad_tol(mode, i, net, share, case)
        for k, w in want.items():
            # sqrt(square_avg) is an RMS of 0.1-weighted gradients: it inherits
            # 0.1 of the gradient tolerance
            _close(got[k].sqrt().numpy(), w.sqrt().numpy(), f"sqrt(square_avg) {net} {k}",
                   1e-3, 0.1 * gtol[k] + 1e-12)

    for k, w in r["jema"].items():
        _close(r["ema"][k].numpy(), w.numpy(), f"ema {k}", 1e-4,
               1e-5 + 2.5 * 10 * LR * r["g_updates"] * 1e-3)


# ------------------------------------------------------ gan_only's second G update
KINK_BLOCK = "decoder.decoder.decoder-depth_0-reconstruction"


def _rel(got: dict, want: dict) -> float:
    """Largest |difference| over a net's gradients, over the net's largest."""
    net = max(float(w.abs().max()) for w in want.values())
    return max(float((got[k] - w).abs().max()) for k, w in want.items()) / net


def gan_only_kink(report=print) -> dict:
    """The numbers behind ``gan_only`` stopping at step 1 in
    :func:`test_other_steps_match_jax`: both packages run its three steps
    ("off" against "off", lr_d = 0, the file's draws), and at step 2 (the
    second G update) the generator gradients are compared across packages,
    each package from the other's state after step 1, each against itself
    under noise, and the pre-activation of ``KINK_BLOCK``'s ``bn1`` nearest 0
    is read in both. Prints them (``python -c "import
    tests.test_torch_train_step as t; t.gan_only_kink()"`` from the repo
    root) and returns them."""
    import copy

    from vaegan_tpu.train.state import build_models as jbuild_models

    jcfg, cfg = configs("off", "off", "gan_only")
    mp = pytest.MonkeyPatch()
    try:
        for mod in (jstep_mod, jstate_mod):
            orig = mod.build_optimizer
            mp.setattr(mod, "build_optimizer",
                       lambda c, role=None, _o=orig: _recording(_o(c, role)))
        js = jstate_mod.create_train_state(jcfg, jax.random.key(0))
        jsteps = {g: jax.jit(lambda s, b, inj, g=g: jstep_mod.make_train_step(
            jcfg, g, inject=inj)(s, b, jax.random.key(1))) for g in (True, False)}
        port = vt.create_train_state(cfg, device="cpu")
        pool = port.critic.pool_shape
        vt.load_jax_train_state(port, js.replace(opt_g=js.opt_g.inner, opt_d=js.opt_d.inner),
                                pool)
        rng = np.random.default_rng(7)
        draws = []
        for do_g in G_STEPS[:3]:   # the draws trajectory("off-vs-off") makes
            batch = rng.random((BATCH, SIZE, SIZE, 1), dtype=np.float32)
            inj = {f"d_masks_{k}": _numpy_critic_masks(port.critic, rng)
                   for k in ("real", "fake", "interp", "gen")}
            inj["alpha"] = torch.from_numpy(rng.random(BATCH).astype(np.float32))
            inj["eps"] = torch.from_numpy(
                rng.standard_normal((BATCH, SIZE // 2, SIZE // 2, 8)).astype(np.float32))
            inj["g_masks"] = {name: torch.from_numpy(rng.random(shape) >= 0.5)
                              for name, shape in _gen_mask_shapes(port.generator)}
            if not do_g:
                inj.pop("d_masks_gen")
            jinj = {k: (_masks_collection(v, "discriminator" if k.startswith("d_") else
                                          "generator") if "masks" in k else
                        jnp.asarray(np.asarray(v))) for k, v in inj.items()}
            draws.append((batch, inj, jinj))
        for i in range(2):
            batch, inj, jinj = draws[i]
            make_train_step(cfg, G_STEPS[i], inject=inj)(port, torch.from_numpy(batch), 100 + i)
            js, _ = jsteps[G_STEPS[i]](js, jnp.asarray(batch), jinj)
        batch, inj, jinj = draws[2]

        def port_g2(state, x=batch):
            st, rec = copy.deepcopy(state), {}
            _record_port(st.opt_g, st.generator, rec)
            make_train_step(cfg, True, inject=inj)(st, torch.from_numpy(x), 102)
            return rec

        def jax_g2(state, x=batch):
            return from_jax_variables({"params": jsteps[True](
                state, jnp.asarray(x), jinj)[0].opt_g.grads})

        out = {}
        port_own, jax_own = port_g2(port), jax_g2(js)
        out["port vs JAX"] = _rel(port_own, jax_own)
        from_jax = vt.create_train_state(cfg, device="cpu")
        vt.load_jax_train_state(from_jax, js.replace(opt_g=js.opt_g.inner,
                                                     opt_d=js.opt_d.inner), pool)
        g = port_g2(from_jax)
        out["port from JAX's state vs port"] = _rel(g, port_own)
        out["port from JAX's state vs JAX"] = _rel(g, jax_own)
        gv = jinterop.reference_generator_to_variables(
            {k: v.numpy() for k, v in port.generator.state_dict().items()})
        dv = jinterop.reference_discriminator_to_variables(
            {k: v.numpy() for k, v in port.critic.state_dict().items()}, pool)
        cast = lambda t, like: jax.tree.map(lambda a, b: jnp.asarray(a, b.dtype), t, like)  # noqa: E731
        js_port = js.replace(
            g_params=cast(gv["params"], js.g_params), g_stats=cast(gv["batch_stats"], js.g_stats),
            d_params=cast(dv["params"], js.d_params), d_stats=cast(dv["batch_stats"], js.d_stats),
            d_spectral=cast(dv["spectral"], js.d_spectral))
        g = jax_g2(js_port)
        out["JAX from the port's state vs JAX"] = _rel(g, jax_own)
        out["JAX from the port's state vs port"] = _rel(g, port_own)
        noise = np.random.default_rng(11)
        for eps in (1e-7, 1e-6):
            x = batch * (1 + eps * noise.standard_normal(batch.shape).astype(np.float32))
            out[f"JAX, batch x (1 + {eps:g} noise)"] = _rel(jax_g2(js, x), jax_own)
            out[f"port, batch x (1 + {eps:g} noise)"] = _rel(port_g2(port, x), port_own)
        for eps in (1e-6, 1e-5):
            jp = jax.tree.map(lambda p: p + eps * jnp.asarray(
                noise.standard_normal(p.shape), p.dtype), js.g_params)
            out[f"JAX, parameters + {eps:g} noise"] = _rel(jax_g2(js.replace(g_params=jp)),
                                                           jax_own)
            st = copy.deepcopy(port)
            with torch.no_grad():
                for p in st.generator.parameters():
                    p.add_(eps * torch.from_numpy(
                        noise.standard_normal(tuple(p.shape)).astype(np.float32)))
            out[f"port, parameters + {eps:g} noise"] = _rel(port_g2(st), port_own)

        # the pre-activation nearest 0 of the block's bn1, in both packages
        seen = []
        bn1 = dict(port.generator.named_modules())[KINK_BLOCK].bn1
        hook = bn1.register_forward_hook(lambda m, i, o: seen.append(o.detach().clone()))
        port_g2(port)
        hook.remove()
        y = seen[0].permute(0, 2, 3, 1)          # NHWC, as JAX's
        jgen, _ = jbuild_models(jcfg)
        _, mut = jgen.apply({"params": js.g_params, "batch_stats": js.g_stats,
                             "masks": jinj["g_masks"]}, jnp.asarray(batch), train=True,
                            rngs={"dropout": jax.random.key(0)}, eps=jinj["eps"],
                            mutable=["batch_stats", "intermediates"], capture_intermediates=True)
        jy = np.asarray(mut["intermediates"]["decoder"][KINK_BLOCK.rsplit(".", 1)[1]]["bn1"]
                        ["__call__"][0])
        at = np.unravel_index(int(np.argmin(np.abs(jy))), jy.shape)
        out["nearest 0: index (n, h, w, c)"] = tuple(int(a) for a in at)
        out["nearest 0: JAX"] = float(jy[at])
        out["nearest 0: port"] = float(y[at])
        out["nearest 0: channel std (port)"] = float(y[..., at[3]].std())
        for k, v in out.items():
            report(f"{k}: {v}")
        return out
    finally:
        mp.undo()


# ------------------------------------------------------ seed 2's KL excursion
def seed2_kl_excursion(steps: int = 100, report=print, argv=()) -> dict:
    """Seed 2's summed KL in both packages, step by step: the recipe of
    ``reproduce_headline --seed 2 --dtype float32 --use-pallas all`` (the
    notebook preset at 256², batch 4, a G update and the penalty every step),
    for ``steps`` steps from the port's seed-2 weights carried into the JAX
    state, on the port's seed-2 batches. Draws: the port's fused step (the plain
    versions on the CPU) draws its dropout masks and noise, which are rebuilt
    and injected into the JAX "losses" step; the critic's masks and the GP
    alphas are drawn here with numpy and injected into both, as in
    :func:`trajectory`. Prints a line a step (``python -c "import
    tests.test_torch_train_step as t; t.seed2_kl_excursion()"`` from the repo
    root) and returns ``{"port": [kl, ...], "jax": [kl, ...]}``. ``argv``: more
    of the script's flags (the test runs it at a small size)."""
    from vaegan_tpu.config import Config as JConfig
    from vaegan_tpu_torch.data.pipeline import make_loader
    from vaegan_tpu_torch.examples import reproduce_headline as rh
    from vaegan_tpu_torch.train.step import step_seed

    cfg = rh.build_config(rh.build_parser().parse_args(
        ["--seed", "2", "--dtype", "float32", "--use-pallas", "all", *argv]))
    jcfg = JConfig.from_dict(cfg.to_dict())
    jcfg = jcfg.replace(train=jcfg.train.replace(use_pallas="losses"))
    port = vt.create_train_state(cfg, device="cpu")
    pool = port.critic.pool_shape
    js = jstate_mod.create_train_state(jcfg, jax.random.key(2))
    gv = jinterop.reference_generator_to_variables(
        {k: v.numpy() for k, v in port.generator.state_dict().items()})
    dv = jinterop.reference_discriminator_to_variables(
        {k: v.numpy() for k, v in port.critic.state_dict().items()}, pool)
    cast = lambda t, like: jax.tree.map(lambda a, b: jnp.asarray(a, b.dtype), t, like)  # noqa: E731
    js = js.replace(
        g_params=cast(gv["params"], js.g_params), g_stats=cast(gv["batch_stats"], js.g_stats),
        d_params=cast(dv["params"], js.d_params), d_stats=cast(dv["batch_stats"], js.d_stats),
        d_spectral=cast(dv["spectral"], js.d_spectral))
    jstep = jax.jit(lambda s, b, inj: jstep_mod.make_train_step(jcfg, True, inject=inj)(
        s, b, jax.random.key(1)))
    step = lambda inj: make_train_step(cfg, True, inject=inj)  # noqa: E731
    rng = np.random.default_rng(2)
    batch_size = cfg.data.batch_size
    out = {"port": [], "jax": []}
    loader = make_loader(cfg.data, seed=cfg.train.seed, device="cpu")
    batches = (b for _ in range(cfg.train.n_epochs) for b in loader)
    for i, batch in zip(range(steps), batches):
        batch = np.asarray(batch, np.float32)
        inj = {f"d_masks_{k}": _numpy_critic_masks(port.critic, rng, batch_size)
               for k in ("real", "fake", "interp", "gen")}
        inj["alpha"] = torch.from_numpy(rng.random(batch_size).astype(np.float32))
        port, metrics = step(inj)(port, torch.from_numpy(batch), step_seed(cfg.train.seed, i))
        jinj = dict(inj)
        jinj.update(fused_draws(port.generator))
        jinj = {k: (_masks_collection(v, "discriminator" if k.startswith("d_") else
                                      "generator") if "masks" in k else
                    jnp.asarray(np.asarray(v))) for k, v in jinj.items()}
        js, jmetrics = jstep(js, jnp.asarray(batch), jinj)
        out["port"].append(float(metrics["kl"]))
        out["jax"].append(float(jmetrics["kl"]))
        report(f"step {i}: KL port {out['port'][-1]!r} JAX {out['jax'][-1]!r}")
    return out


def test_seed2_helper_holds_both_packages_to_one_start(monkeypatch):
    """:func:`seed2_kl_excursion` at a small size (the preset narrowed, 32²):
    the two packages start from the same weights, batches and draws, so the
    first step's summed KL (of the forward before any update) agrees within
    1e-5 relative, and every step's is finite in both."""
    from vaegan_tpu_torch.examples import reproduce_headline as rh

    base = rh.preset

    def narrow(name):
        cfg = base(name)
        return cfg.replace(
            generator=cfg.generator.replace(depth=1, length=1, feature_size=4),
            discriminator=cfg.discriminator.replace(
                num_features_conv1=8, num_blocks=(1, 1), num_strides_res=(1, 2),
                num_features_res=(8, 16), linear_widths=(16, 8)),
            data=cfg.data.replace(synthetic_size=8))

    monkeypatch.setattr(rh, "preset", narrow)
    out = seed2_kl_excursion(steps=3, report=lambda line: None, argv=("--image-size", "32"))
    assert len(out["port"]) == len(out["jax"]) == 3
    assert all(np.isfinite(out["port"] + out["jax"]))
    assert out["port"][0] == pytest.approx(out["jax"][0], rel=1e-5)


def test_gan_only_second_g_update_is_a_kink_of_the_step():
    """What :func:`gan_only_kink` shows that holds whichever side of the kink
    float32 order puts each package: from the other package's state after
    step 1, each package's step-2 generator gradients are within 1e-5 of the
    net's largest of its own (the states agree), and JAX against itself under
    1e-5 parameter noise moves them by over 1e-3 of it (the step amplifies
    noise a hundredfold past this file's tolerance)."""
    out = gan_only_kink(report=lambda line: None)
    assert out["port from JAX's state vs port"] < 1e-5
    assert out["JAX from the port's state vs JAX"] < 1e-5
    assert out["JAX, parameters + 1e-05 noise"] > 1e-3
