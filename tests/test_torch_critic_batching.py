"""``critic_batching="concat"`` / ``"concat3"`` in the port's two train steps,
against the JAX package on the CPU at 32² with the narrow critic and shared
weights of ``tests/test_torch_paper_step.py`` (whose helpers this file uses).

JAX takes injected critic masks only under ``"separate"``: its concatenated
critic forward draws its own bits. So every comparison with JAX runs the critic
at ``discriminator.dropout_prob=0.0``. The two-optimizer steps keep the
generator's dropout at the preset's 0.5: the port fused (``use_pallas="all"``:
the kernels' plain versions on the CPU) draws its own masks and noise, which are
rebuilt (``train.fused_draws``) and injected into JAX ``"losses"``, with the GP
alphas drawn here with numpy. The paper step takes no generator masks in JAX,
so it runs at dropout 0 with ``eps`` and ``z_p`` injected, as the paper-step
tests do, for two steps: at the third, the step itself has a kink near this
trajectory's state. JAX run on the same state with the batch times 1 + 1e-7
noise gives generator gradients 11.85 times the tolerance away from its own
unperturbed run, and the port (fused or not, which agree to 0.01 of it) lands
on the other branch, also 11.85 times it away (measured on the CPU). In the
unfused pairing the same happens at the fourth step, at 2.83 times, for JAX
against itself as for the port against JAX. Past such a point the comparison
measures where the kink falls, not the port. With the critic's dropout on, the port is held only against itself:
fused against unfused, with the fused step's draws replayed.

Tolerances: those of ``tests/test_torch_paper_step.py`` (its docstring):
losses 2e-4 relative + 1e-5; gradients 1e-3 of each tensor's largest plus 1e-5
(generator) or a share of the net's largest (critic: 1e-4 for the BCE paper
critic, 1e-2 for the notebook's clamped WGAN critic, as
``tests/test_torch_train_step.py``); parameters 1e-5 + 1e-4 relative, elements
whose gradient was at noise level held to the update bound; BN statistics
1e-4; spectral u and v 1e-3; ``sqrt(square_avg)`` 1e-3 relative + 0.1 of the
gradient tolerance; the EMA 1e-4 relative. Accumulation against the full batch
on duplicated microbatches: the JAX tests' 2e-3 relative + 1e-5 on metrics and
5e-3 relative + 1e-4 on parameters (``tests/test_train_step.py:171, 231``).
Fused against unfused with the draws replayed: metrics 1e-5 relative + 1e-6,
gradients 1e-3 of each tensor's largest + 1e-6 of the net's.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vaegan_tpu.train.state as jstate_mod
import vaegan_tpu.train.step as jstep_mod
from vaegan_tpu import interop as jinterop
from test_torch_paper_step import (
    BATCH,
    LATENT,
    SIZE,
    _assert_state_matches,
    _close,
    _draws,
    _duplicated,
    _grads_close,
    _inner,
    _patch_recording,
    _record,
    _record_port,
    configs,
    port_cfg,
)
import vaegan_tpu_torch as vt
from vaegan_tpu_torch.train import fused_draws, make_paper_train_step, make_train_step, paper_draws

torch.set_num_threads(1)

STEPS = 4
PAPER_STEPS = 2         # module docstring: a kink of the step itself at the third
WGAN_SHARE = 1e-2       # the clamped critic's gradients: tests/test_torch_train_step.py


def _batching(cfg, batching: str):
    return cfg.replace(train=cfg.train.replace(critic_batching=batching))


def _masks_collection(masks: dict):
    pairs = [(k, np.asarray(v.detach().cpu().numpy(), np.float32)) for k, v in masks.items()]
    return jax.tree.map(jnp.asarray,
                        jinterop.reference_dropout_masks_to_collection(pairs, "generator"))


@functools.lru_cache(maxsize=None)
def notebook_trajectory(batching: str):
    """Four notebook G+D steps of both packages from one JAX state, the critic at
    dropout 0, the port fused with its generator draws replayed into JAX."""
    jcfg, cfg = configs("all", "losses", "notebook", critic_batching=batching,
                        ema_decay=0.999)
    jcfg = jcfg.replace(generator=jcfg.generator.replace(dropout_prob=0.5))
    cfg = cfg.replace(generator=cfg.generator.replace(dropout_prob=0.5))
    mp = pytest.MonkeyPatch()
    try:
        _patch_recording(mp)
        jstate = jstate_mod.create_train_state(jcfg, jax.random.key(0))
        jstep = jax.jit(lambda s, b, inj: jstep_mod.make_train_step(jcfg, True, inject=inj)(
            s, b, jax.random.key(1)))
        state = vt.create_train_state(cfg, device="cpu")
        pool = state.critic.pool_shape
        vt.load_jax_train_state(state, _inner(jstate), pool)
        g_rec, d_rec = {}, {}
        _record_port(state.opt_g, state.generator, g_rec)
        _record_port(state.opt_d, state.critic, d_rec)
        rng = np.random.default_rng(7)
        records = []
        for i in range(STEPS):
            batch = rng.random((BATCH, SIZE, SIZE, 1), dtype=np.float32)
            alpha = rng.random(BATCH).astype(np.float32)
            step = make_train_step(cfg, True, inject={"alpha": torch.from_numpy(alpha)})
            state, metrics = step(state, torch.from_numpy(batch), 100 + i)
            draws = fused_draws(state.generator)
            jinj = {"alpha": jnp.asarray(alpha), "eps": jnp.asarray(draws["eps"].numpy()),
                    "g_masks": _masks_collection(draws["g_masks"])}
            jstate, jmetrics = jstep(jstate, jnp.asarray(batch), jinj)
            records.append(_record(state, jstate, pool, g_rec, d_rec, metrics, jmetrics))
        return records
    finally:
        mp.undo()


@functools.lru_cache(maxsize=None)
def paper_trajectory():
    """``PAPER_STEPS`` ``concat`` paper steps of both packages from one JAX
    state (dropout 0, eps and z_p injected; the port fused, its own eps
    replayed into JAX "losses")."""
    jcfg, cfg = configs("all", "losses", critic_batching="concat")
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
        for i in range(PAPER_STEPS):
            batch = rng.random((BATCH, SIZE, SIZE, 1), dtype=np.float32)
            inj = _draws(rng, "all")
            step = make_paper_train_step(cfg, inject={k: torch.from_numpy(v)
                                                      for k, v in inj.items()})
            state, metrics = step(state, torch.from_numpy(batch), 100 + i)
            inj["eps"] = paper_draws(step, state.generator)["eps"].numpy()
            jstate, jmetrics = jstep(jstate, jnp.asarray(batch),
                                     {k: jnp.asarray(v) for k, v in inj.items()})
            records.append(_record(state, jstate, pool, g_rec, d_rec, metrics, jmetrics))
        return records
    finally:
        mp.undo()


NOTEBOOK_CASES = [(b, i) for b in ("concat", "concat3") for i in range(STEPS)]


@pytest.mark.parametrize("batching,i", NOTEBOOK_CASES,
                         ids=[f"{b}-step{i}" for b, i in NOTEBOOK_CASES])
def test_two_optimizer_step_matches_jax(batching, i):
    """Losses (``gp`` among them: under ``concat3`` the penalty's input gradient
    runs through BN statistics over real, fake and interpolates), each net's
    gradients, parameters, BN and SN state, square_avg and the EMA after each of
    four steps."""
    records = notebook_trajectory(batching)
    assert records[i]["metrics"]["gp"] > 0.0
    _assert_state_matches(records, i, WGAN_SHARE)


@pytest.mark.parametrize("i", range(PAPER_STEPS), ids=[f"step{i}" for i in range(PAPER_STEPS)])
def test_paper_step_matches_jax(i):
    """One critic forward over ``cat(real, x~, x_p)``: the same checks."""
    _assert_state_matches(paper_trajectory(), i)


def test_concat3_without_a_penalty_is_concat():
    """``concat3`` on a lazy-GP off step (``do_gp=False``) takes the two-way
    ``concat`` path, as JAX's ``use_gp`` branch does: bitwise the same step."""
    out = []
    for batching in ("concat", "concat3"):
        cfg = _batching(port_cfg("notebook", dropout=0.5), batching)
        state = vt.create_train_state(cfg, device="cpu")
        _, m = make_train_step(cfg, True, do_gp=False)(
            state, torch.rand(BATCH, SIZE, SIZE, 1, generator=torch.Generator().manual_seed(1)), 4)
        out.append(({k: float(v) for k, v in m.items()},
                    {k: v.clone() for k, v in state.critic.state_dict().items()}))
    (m0, c0), (m1, c1) = out
    assert m0 == m1 and m0["gp"] == 0.0
    assert all(torch.equal(c0[k], c1[k]) for k in c0)


@pytest.mark.parametrize("scheme", ["paper", "notebook"])
def test_accumulation_equals_the_full_batch_on_duplicated_microbatches(scheme):
    """``concat`` with ``grad_accum=2`` on concat(x, x) with the draws
    duplicated: each microbatch's critic forward sees cat(x, fake) and the full
    step's cat(x, x, fake, fake), whose BN statistics are the same, so the
    accumulated update is the full-batch update."""
    name = "vaegan_paper" if scheme == "paper" else "notebook"
    cfg = _batching(port_cfg(name), "concat")
    if scheme == "paper":
        cfg = cfg.replace(loss=cfg.loss.replace(kl_reduction="sum"))
    (sf, mf), (sa, ma) = _duplicated(cfg, scheme, seed=2)
    for k in mf:
        _close(float(ma[k]), float(mf[k]), f"metric {k}", 2e-3, 1e-5)
    for net in ("generator", "critic"):
        want = dict(getattr(sf, net).named_parameters())
        for k, p in getattr(sa, net).named_parameters():
            _close(p.detach().numpy(), want[k].detach().numpy(), f"{net} {k}", 5e-3, 1e-4)


def test_fused_concat_paper_step_holds_the_unfused_one_at_dropout():
    """At p = 0.5 in generator and critic: the fused ``concat`` paper step (its
    critic fused too) against the unfused one with the fused step's generator
    masks and noise injected; the critic's one concatenated forward draws from
    the same device stream in both."""
    out = {}
    for mode in ("all", "off"):
        cfg = _batching(port_cfg(dropout=0.5, mode=mode), "concat")
        state = vt.create_train_state(cfg, device="cpu")
        assert state.critic.use_pallas == (mode == "all")
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
    for k, want in out["off"]["metrics"].items():
        _close(out["all"]["metrics"][k], want, f"metric {k}", 1e-5, 1e-6)
    _grads_close(out["all"]["g"], out["off"]["g"], "generator grad", 1e-6)
    _grads_close(out["all"]["d"], out["off"]["d"], "critic grad", 1e-6)


def test_concat_paper_critic_is_one_forward_and_ignores_the_shared_draw():
    """Under ``concat`` the paper critic runs once per step, over 3 x batch,
    and ``dis_l_shared_dropout`` changes nothing (no draw is rewound)."""
    out = []
    for shared in (True, False):
        cfg = _batching(port_cfg(dropout=0.5, mode="off"), "concat")
        cfg = cfg.replace(loss=cfg.loss.replace(dis_l_shared_dropout=shared))
        state = vt.create_train_state(cfg, device="cpu")
        sizes = []
        hook = state.critic.register_forward_hook(
            lambda mod, inp, o: sizes.append(inp[0].shape[0]))
        _, m = make_paper_train_step(cfg)(state, torch.rand(
            BATCH, SIZE, SIZE, 1, generator=torch.Generator().manual_seed(5)), 6)
        hook.remove()
        assert sizes == [3 * BATCH]
        out.append({k: float(v) for k, v in m.items()})
    assert out[0] == out[1]


@pytest.mark.parametrize("scheme,key", [
    ("notebook", "d_masks_real"), ("notebook", "d_masks_interp"),
    ("paper", "d_masks_tilde"), ("paper", "d_masks_prior")])
@pytest.mark.parametrize("batching", ["concat", "concat3"])
def test_per_forward_critic_masks_are_refused_under_concat(scheme, key, batching):
    """A per-forward critic mask would be silently ignored by the one
    concatenated forward: making the step refuses it, naming the key; the G
    half's ``d_masks_gen`` stays allowed."""
    cfg = _batching(port_cfg("vaegan_paper" if scheme == "paper" else "notebook",
                             mode="off"), batching)
    make = ((lambda inject: make_paper_train_step(cfg, inject=inject)) if scheme == "paper"
            else (lambda inject: make_train_step(cfg, True, inject=inject)))
    with pytest.raises(ValueError, match=key):
        make({key: {}})
    if scheme == "notebook":
        make({"d_masks_gen": {}})
    with pytest.raises(ValueError, match=key):   # before an accumulating step's own check
        (make_paper_train_step if scheme == "paper" else
         (lambda c, inject: make_train_step(c, True, inject=inject)))(
            cfg.replace(train=cfg.train.replace(grad_accum=2)), inject={key: {}})


def test_default_is_separate():
    assert vt.Config().train.critic_batching == "separate"
    assert vt.preset("notebook").train.critic_batching == "separate"
