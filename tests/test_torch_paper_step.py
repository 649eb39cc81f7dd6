"""The port's Larsen Algorithm-1 step and gradient accumulation against the JAX
package, on the CPU at 32² with the narrow critic of
``tests/test_torch_train_step.py`` and shared weights (``load_jax_train_state``).

The JAX paper and accumulating steps take no dropout-mask injection, so the
configurations that are compared with JAX run at dropout 0 (generator and
critic); the noise ``eps``, the prior sample ``z_p`` and the GP ``alpha`` are
drawn here with numpy and injected into both (a fused port step draws its own
``eps``, rebuilt with ``train.paper_draws`` for the JAX step). Two pairings for
four paper steps: the port fused (``use_pallas="all"``: the kernels' plain
versions on the CPU, critic fused too) against JAX ``"losses"``, and ``"off"``
against ``"off"``. The draws come from numpy's seed 8. With seed 7 (the
two-optimizer test's) the fused pairing parts from JAX faster: its critic
gradients differ by 2e-3 of the net's largest at step 0 at batch 4 and by 3e-2
at step 3 at batch 2, while the unfused pairing and the port's own fused
against unfused step stay within 1e-4 there; the fused BN rounds differently
from XLA's, and these draws amplify it (measured on the CPU; not examined
further).

Tolerances. Losses and metrics: 2e-4 relative (+1e-5 absolute); oneDNN and
XLA:CPU sum the convolutions in different orders. Gradients: within 1e-3 of
each tensor's largest gradient plus a share of the network's largest, 1e-5 for
the generator and 1e-4 for the critic (a gradient whose terms cancel carries
float32 noise on the scale of its terms; the BCE critic is not clamped, so no
gradient shrinks to the noise as the WGAN step's does). ``sqrt(square_avg)``:
1e-3 relative plus 0.1 of the gradient tolerance. Parameters: 1e-5 absolute +
1e-4 relative where every recorded gradient was above the noise floor; below
it a sign at cancellation scale decides an RMSprop update, so those elements
are held to the update bound (2.5 * 10 * lr per update). BN running statistics
1e-4; spectral u and v 1e-3; the EMA 1e-4 relative plus 1e-3 of the update
bound. The port's three gradients against JAX ``debug_grads``: the gradient
tolerance above. Accumulation against JAX: one step, with the tolerances
above. Accumulation against the full-batch step on duplicated microbatches
(port only, with the spectral vectors converged first): the JAX tests' own,
metrics 2e-3 relative + 1e-5, parameters 5e-3 relative + 1e-4
(``tests/test_train_step.py:171, 231``).
"""

from __future__ import annotations

import copy
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
from vaegan_tpu.config import preset as jpreset
import vaegan_tpu_torch as vt
from vaegan_tpu_torch import interop
from vaegan_tpu_torch.interop import from_jax_variables
from vaegan_tpu_torch.models.layers import Conv2D
from vaegan_tpu_torch.ops.spectral_norm import spectral_normalize
from vaegan_tpu_torch.train import loop, make_paper_train_step, make_train_step, paper_draws
from vaegan_tpu_torch.utils.metrics import MetricsLogger

# the suite runs files in parallel workers; one intra-op thread each keeps
# torch from taking every core from the other workers
torch.set_num_threads(1)

SIZE, BATCH, LR = 32, 2, 3e-4
LATENT = (SIZE // 2, SIZE // 2, 8)          # depth 1, feature_size 4
STEPS = 4
MODES = {"all-vs-losses": ("all", "losses"), "off-vs-off": ("off", "off")}
G_SHARE, D_SHARE = 1e-5, 1e-4


def narrow(jcfg, dropout: float = 0.0, size: int = SIZE, batch: int = BATCH):
    """``jcfg`` with the small generator and narrow critic of the port's step tests."""
    return jcfg.replace(
        generator=jcfg.generator.replace(depth=1, length=1, feature_size=4,
                                         dropout_prob=dropout),
        discriminator=jcfg.discriminator.replace(
            num_features_conv1=8, num_blocks=(1, 1), num_strides_res=(1, 2),
            num_features_res=(8, 16), linear_widths=(16, 8), dropout_prob=dropout),
        data=jcfg.data.replace(image_size=size, batch_size=batch))


def configs(port_mode: str, jax_mode: str, name: str = "vaegan_paper", **train):
    jcfg = narrow(jpreset(name))
    jcfg = jcfg.replace(train=jcfg.train.replace(use_pallas=jax_mode, **train))
    cfg = vt.Config.from_dict(jcfg.to_dict())
    return jcfg, cfg.replace(train=cfg.train.replace(use_pallas=port_mode))


def port_cfg(name: str = "vaegan_paper", dropout: float = 0.0, mode: str = "all", **train):
    cfg = vt.Config.from_dict(narrow(jpreset(name), dropout).to_dict())
    return cfg.replace(train=cfg.train.replace(use_pallas=mode, **train))


# ---------------------------------------------------------------- recording
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


def _patch_recording(mp) -> None:
    """Make the JAX package's optimizers keep their last raw gradients."""
    for mod in (jstep_mod, jstate_mod):
        orig = mod.build_optimizer
        mp.setattr(mod, "build_optimizer", lambda c, role=None, _o=orig: _recording(_o(c, role)))


@pytest.fixture
def recording(monkeypatch):
    _patch_recording(monkeypatch)


def _record_port(opt, module, store):
    named = list(module.named_parameters())
    inner = opt.step

    def step(*a, **k):
        store.clear()
        store.update({n: p.grad.detach().clone() for n, p in named})
        return inner(*a, **k)

    opt.step = step


def _inner(jstate):
    """The JAX state with the recording wrappers taken off its optimizer states."""
    opt_g = jstate.opt_g
    opt_g = {k: v.inner for k, v in opt_g.items()} if isinstance(opt_g, dict) else opt_g.inner
    return jstate.replace(opt_g=opt_g, opt_d=jstate.opt_d.inner)


def _jnu(s):
    """The ``nu`` tree (RMSprop's, or Adam's in its chain) of a recorded JAX
    optimizer state."""
    return interop._find_state(s.inner, ("nu",)).nu


def _g_tree(opt_g, field: str):
    """A generator-params-shaped JAX tree of ``field`` (``grads`` or ``nu``) from
    either scheme's ``opt_g``, under the port's parameter names."""
    get = (lambda s: s.grads) if field == "grads" else _jnu
    tree = ({**get(opt_g["enc"]), **get(opt_g["dec"])} if isinstance(opt_g, dict)
            else get(opt_g))
    return from_jax_variables({"params": tree})


def _params_tree(tree, spectral, pool):
    """A params-shaped JAX tree of the critic under the port's parameter names."""
    sd = from_jax_variables({"params": tree, "spectral": spectral}, pool)
    return {k: v for k, v in sd.items() if not k.endswith(("weight_u", "weight_v"))}


def _sd(module):
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _nu(opt, module):
    """RMSprop's ``square_avg`` (Adam's ``exp_avg_sq``) by parameter name."""
    key = "exp_avg_sq" if isinstance(opt, torch.optim.Adam) else "square_avg"
    return {n: opt.state[p][key].clone() for n, p in module.named_parameters()}


def _close(got, want, what, rtol, atol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bad = np.abs(got - want) > atol + rtol * np.abs(want)
    assert not bad.any(), (f"{what}: {int(bad.sum())}/{bad.size} out of tolerance, "
                           f"max |diff| {np.abs(got - want).max():.3e}")


def _grad_tol(want: dict, share: float) -> dict:
    net = max(float(w.abs().max()) for w in want.values())
    return {k: 1e-3 * float(w.abs().max()) + share * net for k, w in want.items()}


def _grads_close(got, want, what, share):
    assert set(got) == set(want), what
    tol = _grad_tol(want, share)
    for k, w in want.items():
        _close(got[k].numpy(), w.numpy(), f"{what} {k}", 0.0, tol[k])


def _record(state, jstate, pool, g_rec, d_rec, metrics, jmetrics):
    return dict(
        metrics={k: float(v) for k, v in metrics.items()},
        jmetrics={k: float(v) for k, v in jmetrics.items() if k != "debug_grads"},
        g_grads=dict(g_rec), d_grads=dict(d_rec),
        jg_grads=_g_tree(jstate.opt_g, "grads"),
        jd_grads=_params_tree(jstate.opt_d.grads, jstate.d_spectral, pool),
        gen=_sd(state.generator), critic=_sd(state.critic),
        jgen=from_jax_variables({"params": jstate.g_params, "batch_stats": jstate.g_stats}),
        jcritic=from_jax_variables({"params": jstate.d_params, "batch_stats": jstate.d_stats,
                                    "spectral": jstate.d_spectral}, pool),
        nu_g=_nu(state.opt_g, state.generator), nu_d=_nu(state.opt_d, state.critic),
        jnu_g=_g_tree(jstate.opt_g, "nu"),
        jnu_d=_params_tree(_jnu(jstate.opt_d), jstate.d_spectral, pool),
        ema=None if state.g_ema is None else {k: v.clone() for k, v in state.g_ema.items()},
        jema=None if jstate.g_ema is None else from_jax_variables({"params": jstate.g_ema}))


def _draws(rng, port_mode: str, batch: int = BATCH, notebook: bool = False) -> dict:
    """numpy draws to inject: ``z_p`` (paper) or ``alpha`` (notebook), and ``eps``
    unless a fused paper step draws its own."""
    inj = ({"alpha": rng.random(batch).astype(np.float32)} if notebook else
           {"z_p": rng.standard_normal((batch,) + LATENT).astype(np.float32)})
    if port_mode == "off" or notebook:
        inj["eps"] = rng.standard_normal((batch,) + LATENT).astype(np.float32)
    return inj


@functools.lru_cache(maxsize=None)
def trajectory(mode: str):
    """Four paper steps of both packages from one JAX state; per-step records."""
    port_mode, jax_mode = MODES[mode]
    jcfg, cfg = configs(port_mode, jax_mode)
    mp = pytest.MonkeyPatch()
    try:
        _patch_recording(mp)
        jstate = jstate_mod.create_train_state(jcfg, jax.random.key(0))
        jstep = jax.jit(lambda s, b, inj: jstep_mod.make_paper_train_step(
            jcfg, inject=inj)(s, b, jax.random.key(1)))
        state = vt.create_train_state(cfg, device="cpu")
        pool = state.critic.pool_shape
        vt.load_jax_train_state(state, _inner(jstate), pool)
        g_rec, d_rec = {}, {}
        _record_port(state.opt_g, state.generator, g_rec)
        _record_port(state.opt_d, state.critic, d_rec)
        rng = np.random.default_rng(8)
        records = []
        for i in range(STEPS):
            batch = rng.random((BATCH, SIZE, SIZE, 1), dtype=np.float32)
            inj = _draws(rng, port_mode)
            step = make_paper_train_step(cfg, inject={k: torch.from_numpy(v)
                                                      for k, v in inj.items()})
            state, metrics = step(state, torch.from_numpy(batch), 100 + i)
            if port_mode == "all":
                inj["eps"] = paper_draws(step, state.generator)["eps"].numpy()
            jstate, jmetrics = jstep(jstate, jnp.asarray(batch),
                                     {k: jnp.asarray(v) for k, v in inj.items()})
            records.append(_record(state, jstate, pool, g_rec, d_rec, metrics, jmetrics))
        return records
    finally:
        mp.undo()


def _noisy(records, i: int, net: str, share: float) -> dict:
    """Per parameter, the elements whose gradient was within the gradient
    tolerance of zero at some update up to step ``i``."""
    noisy = {}
    for rec in records[:i + 1]:
        want = rec[f"j{net}_grads"]
        tol = _grad_tol(want, share)
        for k, w in want.items():
            noisy[k] = (np.abs(w.numpy()) <= tol[k]) | noisy.get(k, False)
    return noisy


def _assert_state_matches(records, i: int, d_share: float = D_SHARE):
    r = records[i]
    assert set(r["metrics"]) == set(r["jmetrics"])
    for k, want in r["jmetrics"].items():
        _close(r["metrics"][k], want, f"metric {k}", 2e-4, 1e-5)
    _grads_close(r["d_grads"], r["jd_grads"], "critic grad", d_share)
    _grads_close(r["g_grads"], r["jg_grads"], "generator grad", G_SHARE)
    for net, gkey, share in (("gen", "g", G_SHARE), ("critic", "d", d_share)):
        got, want = r[net], r["j" + net]
        noisy = _noisy(records, i, gkey, share)
        for k, w in want.items():
            g = got[k]
            if k.endswith(("running_mean", "running_var")):
                _close(g.numpy(), w.numpy(), f"{net} {k}", 1e-4, 1e-4)
            elif k.endswith(("weight_u", "weight_v")):
                _close(g.numpy(), w.numpy(), f"{net} {k}", 0.0, 1e-3)
            elif not k.endswith("num_batches_tracked"):
                tol = 1e-5 + 1e-4 * np.abs(w.numpy())
                tol = np.where(noisy[k], np.maximum(tol, 2.5 * 10 * LR * (i + 1)), tol)
                diff = np.abs(g.numpy() - w.numpy())
                assert (diff <= tol).all(), f"{net} {k}: max |diff| {diff.max():.3e}"
    for net, share in (("g", G_SHARE), ("d", d_share)):
        got, want = r[f"nu_{net}"], r[f"jnu_{net}"]
        gtol = {}
        for rec in records[:i + 1]:
            for k, v in _grad_tol(rec[f"j{net}_grads"], share).items():
                gtol[k] = max(v, gtol.get(k, 0.0))
        for k, w in want.items():
            _close(got[k].sqrt().numpy(), w.sqrt().numpy(), f"sqrt(square_avg) {net} {k}",
                   1e-3, 0.1 * gtol[k] + 1e-12)
    if r["jema"] is not None:
        for k, w in r["jema"].items():
            _close(r["ema"][k].numpy(), w.numpy(), f"ema {k}", 1e-4,
                   1e-5 + 2.5 * 10 * LR * (i + 1) * 1e-3)


CASES = [(m, i) for m in MODES for i in range(STEPS)]


@pytest.mark.parametrize("mode,i", CASES, ids=[f"{m}-step{i}" for m, i in CASES])
def test_paper_step_matches_jax(mode, i):
    """Losses, each group's gradients, square_avg (one opt_g against JAX's
    opt_g["enc"] and opt_g["dec"]), BN and SN state and the EMA after each of
    four steps."""
    _assert_state_matches(trajectory(mode), i)


# ---------------------------------------------------------------- debug_grads
@pytest.fixture(scope="module")
def debug_pair():
    """One port paper step and one JAX step with ``debug_grads`` from one state."""
    jcfg, cfg = configs("all", "losses")
    mp = pytest.MonkeyPatch()
    try:
        _patch_recording(mp)
        jstate = jstate_mod.create_train_state(jcfg, jax.random.key(3))
        state = vt.create_train_state(cfg, device="cpu")
        pool = state.critic.pool_shape
        vt.load_jax_train_state(state, _inner(jstate), pool)
        g_rec, d_rec = {}, {}
        _record_port(state.opt_g, state.generator, g_rec)
        _record_port(state.opt_d, state.critic, d_rec)
        rng = np.random.default_rng(11)
        batch = rng.random((BATCH, SIZE, SIZE, 1), dtype=np.float32)
        inj = _draws(rng, "off")
        step = make_paper_train_step(cfg, inject={k: torch.from_numpy(v) for k, v in inj.items()})
        step(state, torch.from_numpy(batch), 5)
        _, m = jax.jit(lambda s, b: jstep_mod.make_paper_train_step(
            jcfg, debug_grads=True, inject={k: jnp.asarray(v) for k, v in inj.items()})(
                s, b, jax.random.key(2)))(jstate, jnp.asarray(batch))
        return dict(port=(dict(g_rec), dict(d_rec)), debug=m["debug_grads"], pool=pool,
                    spectral=jstate.d_spectral)
    finally:
        mp.undo()


@pytest.mark.parametrize("form", ["combined", "explicit"])
def test_three_gradients_match_jax_debug_grads(debug_pair, form):
    """The port's three ``autograd.grad`` calls over one forward against JAX's
    one-backward stop-gradient form and its three explicit gradients."""
    enc, dec, dis = debug_pair["debug"][form]
    g_port, d_port = debug_pair["port"]
    _grads_close(g_port, from_jax_variables({"params": {**enc, **dec}}), "generator grad",
                 G_SHARE)
    _grads_close(d_port, _params_tree(dis, debug_pair["spectral"], debug_pair["pool"]),
                 "critic grad", D_SHARE)


# ---------------------------------------------------------------- accumulation vs JAX
@pytest.mark.parametrize("scheme", ["paper", "notebook"])
def test_accumulating_step_matches_jax(recording, scheme):
    """One ``grad_accum=2`` step of each scheme (port fused, JAX "losses") from
    one state, with eps / z_p / alpha injected: metrics, gradients, parameters,
    BN state and square_avg as in the four-step comparison."""
    name = "vaegan_paper" if scheme == "paper" else "notebook"
    jcfg, cfg = configs("all", "losses", name, grad_accum=2, ema_decay=0.999)
    jstate = jstate_mod.create_train_state(jcfg, jax.random.key(4))
    state = vt.create_train_state(cfg, device="cpu")
    pool = state.critic.pool_shape
    vt.load_jax_train_state(state, _inner(jstate), pool)
    g_rec, d_rec = {}, {}
    _record_port(state.opt_g, state.generator, g_rec)
    _record_port(state.opt_d, state.critic, d_rec)
    rng = np.random.default_rng(5)
    batch = rng.random((2 * BATCH, SIZE, SIZE, 1), dtype=np.float32)
    inj = _draws(rng, "off", 2 * BATCH, notebook=scheme == "notebook")
    tinj = {k: torch.from_numpy(v) for k, v in inj.items()}
    jinj = {k: jnp.asarray(v) for k, v in inj.items()}
    if scheme == "paper":
        step = make_paper_train_step(cfg, inject=tinj)
        jfn = jstep_mod.make_paper_train_step(jcfg, inject=jinj)
    else:
        step = make_train_step(cfg, True, inject=tinj)
        jfn = jstep_mod.make_train_step(jcfg, True, inject=jinj)
    state, metrics = step(state, torch.from_numpy(batch), 9)
    jstate, jmetrics = jax.jit(lambda s, b: jfn(s, b, jax.random.key(6)))(
        jstate, jnp.asarray(batch))
    rec = _record(state, jstate, pool, g_rec, d_rec, metrics, jmetrics)
    # the notebook's clamped WGAN critic: test_torch_train_step.py's critic share
    _assert_state_matches([rec], 0, D_SHARE if scheme == "paper" else 1e-2)


# ---------------------------------------------------------------- accumulation, port only
def _converge_spectral(critic, iterations: int = 2000) -> None:
    """Each spectral layer's (u, v) advanced to its weight's top singular pair."""
    for m in critic.modules():
        if isinstance(m, Conv2D) and m.spectral:
            _, u, v = spectral_normalize(m.weight_orig.detach(), m.weight_u, m.weight_v,
                                         update=True, n_iterations=iterations)
            m.weight_u.copy_(u)
            m.weight_v.copy_(v)


def _duplicated(cfg, scheme: str, seed: int):
    """The full-batch and grad_accum=2 steps on concat(x, x) with the draws
    duplicated too, from one state after three full steps. The spectral (u, v)
    are then converged: each critic forward runs one power iteration, so the
    accumulating step's two microbatches advance them twice as often as the
    full step, and the JAX tests' warm-up steps (which move W too) leave them
    far enough from converged at these shapes that this alone parts the two
    steps by 1e-2. Returns ((state, metrics) full, (state, metrics)
    accumulated)."""
    make = ((lambda c, inject=None: make_paper_train_step(c, inject=inject))
            if scheme == "paper" else
            (lambda c, inject=None: make_train_step(c, True, inject=inject)))
    cfg_acc = cfg.replace(train=cfg.train.replace(grad_accum=2))
    state = vt.create_train_state(cfg, device="cpu", seed=seed)
    g = torch.Generator().manual_seed(seed)
    for i in range(3):
        state, _ = make(cfg)(state, torch.rand((4, SIZE, SIZE, 1), generator=g), 20 + i)
    _converge_spectral(state.critic)
    x = torch.rand((2, SIZE, SIZE, 1), generator=g)
    draw = (lambda *s: torch.randn(s, generator=g))
    inj = ({"z_p": draw(2, *LATENT), "eps": draw(2, *LATENT)} if scheme == "paper" else
           {"eps": draw(2, *LATENT), "alpha": torch.rand(2, generator=g)})
    inj = {k: torch.cat([v, v]) for k, v in inj.items()}
    batch = torch.cat([x, x])
    out = []
    for c in (cfg, cfg_acc):
        st = vt.create_train_state(cfg, device="cpu", seed=seed)
        st.generator.load_state_dict(state.generator.state_dict())
        st.critic.load_state_dict(state.critic.state_dict())
        # a loaded optimizer state shares the given tensors: copy them
        st.opt_g.load_state_dict(copy.deepcopy(state.opt_g.state_dict()))
        st.opt_d.load_state_dict(copy.deepcopy(state.opt_d.state_dict()))
        out.append(make(c, inject=inj)(st, batch, 9))
    return out


@pytest.mark.parametrize("scheme", ["paper", "notebook"])
def test_accumulation_equals_the_full_batch_on_duplicated_microbatches(scheme):
    """With the batch concat(x, x), dropout 0 and the draws duplicated, each
    microbatch's BN statistics are the full batch's: the accumulated update is
    the full-batch update (up to the spectral power iteration's cadence), as in
    ``tests/test_train_step.py:171, 231``."""
    name = "vaegan_paper" if scheme == "paper" else "notebook"
    cfg = port_cfg(name)
    if scheme == "paper":          # the JAX test's sum-reduced KL, scaled by grad_accum
        cfg = cfg.replace(loss=cfg.loss.replace(kl_reduction="sum"))
    (sf, mf), (sa, ma) = _duplicated(cfg, scheme, seed=2)
    for k in mf:
        _close(float(ma[k]), float(mf[k]), f"metric {k}", 2e-3, 1e-5)
    for net in ("generator", "critic"):
        want = dict(getattr(sf, net).named_parameters())
        for k, p in getattr(sa, net).named_parameters():
            _close(p.detach().numpy(), want[k].detach().numpy(), f"{net} {k}", 5e-3, 1e-4)


def test_two_optimizer_recompute_keeps_pass_one_bn_statistics():
    """Pass 2 recomputes each microbatch's generator forward; the generator's BN
    running statistics stay as pass 1 left them: a G step leaves them bitwise
    as a critic-only step (pass 1 alone) does, and they moved."""
    cfg = port_cfg("notebook", dropout=0.5, grad_accum=2)
    x = torch.rand((4, SIZE, SIZE, 1), generator=torch.Generator().manual_seed(1))
    before = _sd(vt.create_train_state(cfg, device="cpu").generator)
    after = {}
    for do_g in (True, False):
        state = vt.create_train_state(cfg, device="cpu")
        make_train_step(cfg, do_g)(state, x, 3)
        after[do_g] = {k: v for k, v in _sd(state.generator).items()
                       if k.endswith(("running_mean", "running_var"))}
    for k, v in after[False].items():
        assert torch.equal(after[True][k], v), k
    assert any(not torch.equal(v, before[k]) for k, v in after[False].items())


@pytest.mark.parametrize("scheme", ["paper", "notebook"])
def test_batch_not_divisible_by_grad_accum_raises(scheme):
    cfg = port_cfg("vaegan_paper" if scheme == "paper" else "notebook", grad_accum=2)
    state = vt.create_train_state(cfg, device="cpu")
    step = (make_paper_train_step(cfg) if scheme == "paper" else make_train_step(cfg, True))
    with pytest.raises(ValueError, match="not divisible by grad_accum 2"):
        step(state, torch.rand(3, SIZE, SIZE, 1), 0)


# ---------------------------------------------------------------- the paper step, port only
def test_dis_l_recon_decreases_on_a_fixed_batch():
    """Six paper steps on one batch (kl_weight 0.01, as ``tests/test_train_step.py:340``):
    finite losses, and the Dis_l reconstruction falls."""
    cfg = port_cfg()
    cfg = cfg.replace(loss=cfg.loss.replace(kl_weight=0.01),
                      optim=cfg.optim.replace(gamma=1.0))
    state = vt.create_train_state(cfg, device="cpu")
    x = torch.rand((4, SIZE, SIZE, 1), generator=torch.Generator().manual_seed(1))
    step = make_paper_train_step(cfg)
    vals = [float(step(state, x, 5 + i)[1]["recon_loss"]) for i in range(6)]
    assert all(np.isfinite(vals)), vals
    assert vals[-1] < vals[0], vals


def test_paper_step_tracks_the_ema():
    cfg = port_cfg(ema_decay=0.5)
    state = vt.create_train_state(cfg, device="cpu")
    ema0 = {k: v.clone() for k, v in state.g_ema.items()}
    make_paper_train_step(cfg)(state, torch.rand(BATCH, SIZE, SIZE, 1), 1)
    for k, p in state.generator.named_parameters():
        torch.testing.assert_close(state.g_ema[k], 0.5 * ema0[k] + 0.5 * p.detach(),
                                   atol=1e-7, rtol=0.0)


def _critic_masks(critic):
    """Hooks recording each critic Dropout2d's keep-mask (B, C) per call."""
    seen = []
    hooks = [m.dropout.register_forward_hook(
        lambda mod, inp, out: seen.append((out != 0).flatten(2).any(2)))
        for m in critic.modules() if isinstance(m, vt.models.ResBlockDiscriminator)]
    return seen, hooks


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "independent"])
def test_critic_dropout_of_the_dis_l_pair(shared):
    """At p = 0.5, with ``dis_l_shared_dropout`` the real and x~ critic forwards
    draw one mask and x_p its own; without it all three differ."""
    cfg = port_cfg(dropout=0.5)
    cfg = cfg.replace(loss=cfg.loss.replace(dis_l_shared_dropout=shared))
    state = vt.create_train_state(cfg, device="cpu")
    seen, hooks = _critic_masks(state.critic)
    make_paper_train_step(cfg)(state, torch.rand(4, SIZE, SIZE, 1), 3)
    for h in hooks:
        h.remove()
    n = len(seen) // 3          # modules per forward
    real, tilde, prior = (torch.cat(seen[j * n:(j + 1) * n], 1) for j in range(3))
    assert real.float().mean().item() not in (0.0, 1.0)
    assert torch.equal(real, tilde) == shared
    assert not torch.equal(real, prior) and not torch.equal(tilde, prior)


@pytest.mark.parametrize("adversarial,clamped", [("bce", False), ("wgan", True)])
def test_only_a_wgan_critic_is_clamped(adversarial, clamped):
    cfg = port_cfg()
    cfg = cfg.replace(loss=cfg.loss.replace(adversarial=adversarial, clip_value=0.01),
                      optim=cfg.optim.replace(lr=1e-2))
    state = vt.create_train_state(cfg, device="cpu")
    make_paper_train_step(cfg)(state, torch.rand(BATCH, SIZE, SIZE, 1), 1)
    biggest = max(float(p.detach().abs().max()) for p in state.critic.parameters())
    assert (biggest <= 0.01 + 1e-7) == clamped, biggest


def test_fused_replay_holds_the_unfused_paper_step():
    """A fused paper step at p = 0.5 against the unfused one with the fused
    step's masks and noise of both generator forwards injected (the critic's
    masks come from the same device stream in both): the same losses and
    gradients to float32 rounding."""
    out = {}
    for mode in ("all", "off"):
        cfg = port_cfg(dropout=0.5, mode=mode)
        state = vt.create_train_state(cfg, device="cpu")
        g_rec, d_rec = {}, {}
        _record_port(state.opt_g, state.generator, g_rec)
        _record_port(state.opt_d, state.critic, d_rec)
        inj = {"z_p": torch.randn((BATCH,) + LATENT, generator=torch.Generator().manual_seed(4))}
        if mode == "off":
            inj.update(out["all"]["draws"])
        step = make_paper_train_step(cfg, inject=inj)
        _, m = step(state, torch.rand(BATCH, SIZE, SIZE, 1,
                                      generator=torch.Generator().manual_seed(2)), 8)
        out[mode] = dict(metrics={k: float(v) for k, v in m.items()}, g=dict(g_rec),
                         d=dict(d_rec),
                         draws=paper_draws(step, state.generator) if mode == "all" else None)
    assert set(out["all"]["draws"]) == {"g_masks", "g_masks_p", "eps"}
    for k, want in out["off"]["metrics"].items():
        _close(out["all"]["metrics"][k], want, f"metric {k}", 1e-5, 1e-6)
    _grads_close(out["all"]["g"], out["off"]["g"], "generator grad", 1e-6)
    _grads_close(out["all"]["d"], out["off"]["d"], "critic grad", 1e-6)


# ---------------------------------------------------------------- interop
def test_a_three_optimizer_jax_state_loads_and_steps_like_jax(recording):
    """Two JAX paper steps, then the state into the port (opt_g's "enc" and
    "dec" nu into the one opt_g), then one step in each."""
    jcfg, cfg = configs("off", "off")
    jstate = jstate_mod.create_train_state(jcfg, jax.random.key(0))
    rng = np.random.default_rng(3)
    jrun = jax.jit(lambda s, b, inj: jstep_mod.make_paper_train_step(jcfg, inject=inj)(
        s, b, jax.random.key(1)))
    for _ in range(2):
        inj = _draws(rng, "off")
        jstate, _ = jrun(jstate, jnp.asarray(rng.random((BATCH, SIZE, SIZE, 1), np.float32)),
                         {k: jnp.asarray(v) for k, v in inj.items()})
    state = vt.create_train_state(cfg, device="cpu", seed=9)
    pool = state.critic.pool_shape
    vt.load_jax_train_state(state, _inner(jstate), pool)
    assert state.step == 2
    for k, v in _nu(state.opt_g, state.generator).items():
        assert torch.equal(v, _g_tree(jstate.opt_g, "nu")[k]), k
    g_rec, d_rec = {}, {}
    _record_port(state.opt_g, state.generator, g_rec)
    _record_port(state.opt_d, state.critic, d_rec)
    batch = rng.random((BATCH, SIZE, SIZE, 1), np.float32)
    inj = _draws(rng, "off")
    state, metrics = make_paper_train_step(cfg, inject={k: torch.from_numpy(v) for k, v in
                                                        inj.items()})(
        state, torch.from_numpy(batch), 0)
    jstate, jmetrics = jrun(jstate, jnp.asarray(batch), {k: jnp.asarray(v) for k, v in inj.items()})
    assert state.step == int(jstate.step) == 3
    rec = _record(state, jstate, pool, g_rec, d_rec, metrics, jmetrics)
    for k, want in rec["jmetrics"].items():
        _close(rec["metrics"][k], want, f"metric {k}", 2e-4, 1e-5)
    _grads_close(rec["g_grads"], rec["jg_grads"], "generator grad", G_SHARE)
    _grads_close(rec["d_grads"], rec["jd_grads"], "critic grad", D_SHARE)
    for k, w in rec["jnu_g"].items():
        _close(rec["nu_g"][k].sqrt().numpy(), w.sqrt().numpy(), f"sqrt(square_avg) {k}",
               1e-3, 1e-6)


@pytest.mark.parametrize("scheme", ["notebook", "paper"])
def test_a_jax_adam_state_loads_and_steps_like_jax(recording, scheme):
    """``optim.optimizer="adam"``: two JAX steps, then the state into the port
    (optax's ``(count, mu, nu)`` as torch Adam's ``step``, ``exp_avg``,
    ``exp_avg_sq``; the paper scheme's ``opt_g`` "enc" and "dec" into the one
    ``opt_g``), then one step in each, held as the four-step comparison holds
    a step (``exp_avg_sq`` as ``square_avg``)."""
    name = "vaegan_paper" if scheme == "paper" else "notebook"
    jcfg, cfg = configs("off", "off", name)
    jcfg = jcfg.replace(optim=jcfg.optim.replace(optimizer="adam"))
    cfg = cfg.replace(optim=cfg.optim.replace(optimizer="adam"))
    jstate = jstate_mod.create_train_state(jcfg, jax.random.key(0))
    notebook = scheme == "notebook"
    make = ((lambda inj: jstep_mod.make_train_step(jcfg, True, inject=inj)) if notebook
            else (lambda inj: jstep_mod.make_paper_train_step(jcfg, inject=inj)))
    jrun = jax.jit(lambda s, b, inj: make(inj)(s, b, jax.random.key(1)))
    rng = np.random.default_rng(11)
    for _ in range(2):
        inj = _draws(rng, "off", notebook=notebook)
        jstate, _ = jrun(jstate, jnp.asarray(rng.random((BATCH, SIZE, SIZE, 1), np.float32)),
                         {k: jnp.asarray(v) for k, v in inj.items()})
    state = vt.create_train_state(cfg, device="cpu", seed=9)
    pool = state.critic.pool_shape
    vt.load_jax_train_state(state, _inner(jstate), pool)
    assert state.step == 2 and isinstance(state.opt_g, torch.optim.Adam)
    count, trees = interop._opt_trees(_inner(jstate).opt_g, ("count", "mu", "nu"))
    want = {k: from_jax_variables({"params": t}) for k, t in trees.items()}
    assert count == 2
    for n, p in state.generator.named_parameters():
        st = state.opt_g.state[p]
        assert float(st["step"]) == 2.0, n
        assert torch.equal(st["exp_avg"], want["mu"][n]), n
        assert torch.equal(st["exp_avg_sq"], want["nu"][n]), n
    g_rec, d_rec = {}, {}
    _record_port(state.opt_g, state.generator, g_rec)
    _record_port(state.opt_d, state.critic, d_rec)
    batch = rng.random((BATCH, SIZE, SIZE, 1), np.float32)
    inj = _draws(rng, "off", notebook=notebook)
    tinj = {k: torch.from_numpy(v) for k, v in inj.items()}
    step = (make_train_step(cfg, True, inject=tinj) if notebook
            else make_paper_train_step(cfg, inject=tinj))
    state, metrics = step(state, torch.from_numpy(batch), 0)
    jstate, jmetrics = jrun(jstate, jnp.asarray(batch), {k: jnp.asarray(v) for k, v in inj.items()})
    assert state.step == int(jstate.step) == 3
    rec = _record(state, jstate, pool, g_rec, d_rec, metrics, jmetrics)
    # the notebook's clamped WGAN critic: test_torch_train_step.py's critic share
    _assert_state_matches([rec], 0, 1e-2 if notebook else D_SHARE)


# ---------------------------------------------------------------- the loop
def _loop_cfg(tmp_path, **train):
    cfg = port_cfg("notebook", sample_dir=str(tmp_path / "s"), n_epochs=1, **train)
    return cfg.replace(data=cfg.data.replace(synthetic=True, synthetic_size=18, batch_size=4))


def test_loop_under_grad_accum_drops_the_partial_batch(tmp_path):
    """18 images at batch 4: the tail of 2 cannot be cut into 2 microbatches,
    so the default loader drops it (``tests/test_loop_and_inference.py:108``)."""
    state, logger = vt.train(_loop_cfg(tmp_path, grad_accum=2, sample_interval=0),
                             device="cpu", logger=MetricsLogger(sinks=[]))
    h = [m for m in logger.history if "_wall_s" not in m]
    assert state.step == 4 and len(h) == 4
    assert all(np.isfinite(v) for m in h for v in m.values())


@pytest.mark.parametrize("scheme,accum", [("paper", 1), ("paper", 2), ("notebook", 2)])
def test_sampler_regenerates_microbatch_zero(tmp_path, scheme, accum):
    """The sampler returns the images the step trains on (under grad_accum, its
    first microbatch's), and leaves the state as it was."""
    cfg = port_cfg("vaegan_paper" if scheme == "paper" else "notebook", dropout=0.5,
                   grad_accum=accum)
    state = vt.create_train_state(cfg, device="cpu")
    x = torch.rand((4, SIZE, SIZE, 1), generator=torch.Generator().manual_seed(6))
    before = _sd(state.generator)
    sample = loop.make_sampler(cfg)(state, x, 41)
    assert all(torch.equal(v, before[k]) for k, v in _sd(state.generator).items())
    seen = []
    hook = state.generator.register_forward_hook(lambda m, i, out: seen.append(out[0].detach()))
    (make_paper_train_step(cfg) if scheme == "paper" else make_train_step(cfg, True))(
        state, x, 41)
    hook.remove()
    assert sample.shape == (4 // accum, SIZE, SIZE, 1)
    assert torch.equal(sample, seen[0])


@pytest.mark.parametrize("accum", [1, 2])
def test_train_runs_the_paper_preset(tmp_path, accum):
    """``vt.train`` of ``vaegan_paper`` (narrowed) runs the paper step on every
    batch: two steps, finite metrics, no penalty, a grid and a checkpoint."""
    cfg = port_cfg(dropout=0.5, grad_accum=accum, n_epochs=1, max_steps=2, sample_interval=2,
                   sample_dir=str(tmp_path / "s"), checkpoint_dir=str(tmp_path / "ck"))
    cfg = cfg.replace(data=cfg.data.replace(synthetic=True, synthetic_size=12, batch_size=4))
    state, logger = vt.train(cfg, device="cpu", logger=MetricsLogger(sinks=[]))
    h = [m for m in logger.history if "_wall_s" not in m]
    assert state.step == 2 and len(h) == 2
    assert all(np.isfinite(v) for m in h for v in m.values())
    assert all(m["gp"] == 0.0 and m["d_loss"] == m["adv_loss"] for m in h)
    assert sorted(p.name for p in (tmp_path / "s").iterdir()) == ["0.png"]
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["2.pt"]
