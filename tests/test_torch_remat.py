"""Recomputation (``cfg.train.remat``) and the fused draws' index base.

``remat`` runs every residual block of the generator and the critic under
``torch.utils.checkpoint`` (``models.layers.remat``): the backward runs each
block's forward again. The step must not change: the same gradients, and the
block's side effects written once per forward, not once per run of it (BN
running statistics, the spectral vectors ``weight_u`` / ``weight_v``, the
fused sites' seeds in the draw record, the unfused dropout masks). Three steps
of each scheme with remat on and off, from the same weights and seeds, are
compared. Tolerance: none. The rerun is the same CPU kernels on the same
inputs, so gradients, metrics and state are bitwise equal; a second
running-statistic update (momentum applied twice), a second power iteration
or a redrawn mask would each change them.

The index base: rows 1-4's plain versions draw element ``base + i`` of the
stream, so a tensor with base b is bitwise the slice ``[b, b + n)`` of the
same draw over a larger tensor (how a data-parallel process draws its rows).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import vaegan_tpu_torch as vt
from vaegan_tpu_torch.models import ResBlockDiscriminator, ResBlockVAE, layers
from vaegan_tpu_torch.ops import fused
from vaegan_tpu_torch.ops.replica import Replica
from vaegan_tpu_torch.train import make_paper_train_step, make_train_step
from vaegan_tpu_torch.train.step import draw_record

torch.set_num_threads(1)

SIZE, BATCH = 16, 4
G_STEPS = (True, False, True)


def tiny_cfg(remat: bool, mode: str = "all", paper: bool = False, **train) -> vt.Config:
    cfg = vt.preset("vaegan_paper" if paper else "notebook")
    return cfg.replace(
        generator=cfg.generator.replace(depth=1, length=2, feature_size=4),
        discriminator=cfg.discriminator.replace(
            num_features_conv1=8, num_blocks=(1, 1), num_strides_res=(1, 2),
            num_features_res=(8, 16), linear_widths=(16, 8)),
        data=cfg.data.replace(image_size=SIZE, batch_size=BATCH),
        train=cfg.train.replace(use_pallas=mode, ema_decay=0.999, remat=remat, **train))


def _recording(opt, module, store):
    named = list(module.named_parameters())
    inner = opt.step

    def step(*a, **k):
        store.update({n: p.grad.detach().clone() for n, p in named})
        return inner(*a, **k)

    opt.step = step


def _unfused_inject(state, rng):
    """Critic and generator masks for an unfused step, drawn with numpy."""
    shapes = {}
    hooks = [m.register_forward_hook(
        lambda mod, inp, out, name=name: shapes.__setitem__(name, tuple(inp[0].shape)))
        for name, m in state.generator.named_modules() if isinstance(m, vt.models.Dropout)]
    with torch.no_grad():
        state.generator(torch.zeros(BATCH, SIZE, SIZE, 1), train=False)
    for h in hooks:
        h.remove()
    inj = {"g_masks": {n: torch.from_numpy(rng.random(s) >= 0.5) for n, s in shapes.items()}}
    for k in ("real", "fake", "interp", "gen"):
        inj[f"d_masks_{k}"] = {
            f"{n}.dropout": torch.from_numpy(rng.random((BATCH, m.conv1.weight_orig.shape[0],
                                                         1, 1)) >= 0.5)
            for n, m in state.critic.named_modules() if isinstance(m, ResBlockDiscriminator)}
    return inj


def run(remat: bool, scheme: str, calls=None):
    mode = "off" if scheme == "off-injected" else "all"
    paper = scheme == "paper"
    cfg = tiny_cfg(remat, mode, paper, grad_accum=2 if scheme == "accum2" else 1)
    state = vt.create_train_state(cfg, device="cpu")
    grads = {}
    _recording(state.opt_g, state.generator, grads)
    _recording(state.opt_d, state.critic, grads)
    rng = np.random.default_rng(0)
    out = []
    for i, do_g in enumerate(G_STEPS):
        batch = torch.from_numpy(rng.random((BATCH, SIZE, SIZE, 1), dtype=np.float32))
        inj = _unfused_inject(state, rng) if scheme == "off-injected" else None
        if inj is not None and not do_g:
            inj.pop("d_masks_gen")
        step = make_paper_train_step(cfg) if paper else make_train_step(cfg, do_g, inject=inj)
        grads.clear()
        state, metrics = step(state, batch, 100 + i)
        out.append({
            "metrics": {k: float(v) for k, v in metrics.items()}, "grads": dict(grads),
            "draws": draw_record(state.generator),
            "state": {**{f"g.{k}": v.clone() for k, v in state.generator.state_dict().items()},
                      **{f"d.{k}": v.clone() for k, v in state.critic.state_dict().items()},
                      **{f"ema.{k}": v.clone() for k, v in state.g_ema.items()}}})
    return out


SCHEMES = ["wgan-gp", "paper", "accum2", "off-injected"]


@pytest.fixture(scope="module")
def block_calls():
    """Block forwards per run, counted through the two block classes."""
    counts = {}
    orig = {cls: cls.forward for cls in (ResBlockVAE, ResBlockDiscriminator)}

    def counting(cls):
        def forward(self, *a, **k):
            counts[cls] = counts.get(cls, 0) + 1
            return orig[cls](self, *a, **k)
        return forward

    mp = pytest.MonkeyPatch()
    for cls in orig:
        mp.setattr(cls, "forward", counting(cls))
    yield counts
    mp.undo()


@pytest.mark.parametrize("scheme", SCHEMES)
def test_remat_changes_nothing(scheme, block_calls):
    block_calls.clear()
    plain = run(False, scheme)
    plain_calls = dict(block_calls)
    block_calls.clear()
    rem = run(True, scheme)
    # the backward really reran the blocks of both networks
    for cls in (ResBlockVAE, ResBlockDiscriminator):
        assert block_calls[cls] > plain_calls[cls], cls.__name__
    for i, (a, b) in enumerate(zip(plain, rem)):
        assert a["metrics"] == b["metrics"], i
        assert a["draws"] == b["draws"], i          # each fused seed drawn once
        assert a["grads"].keys() == b["grads"].keys()
        for k in a["grads"]:
            assert torch.equal(a["grads"][k], b["grads"][k]), f"step {i} grad {k}"
        for k in a["state"]:                        # BN, SN u/v, params, EMA
            assert torch.equal(a["state"][k], b["state"][k]), f"step {i} {k}"


def test_remat_only_when_a_graph_is_recorded(block_calls):
    cfg = tiny_cfg(True)
    gen = vt.build_generator(cfg, device="cpu")
    x = torch.rand(BATCH, SIZE, SIZE, 1)
    n_blocks = sum(1 for m in gen.modules() if isinstance(m, ResBlockVAE))
    for train, grad in ((False, True), (True, False)):
        block_calls.clear()
        with torch.set_grad_enabled(grad):
            out = gen(x, train=train, seeds=torch.Generator().manual_seed(0))
        (out[0].sum() if grad else out[0]).detach()
        assert block_calls[ResBlockVAE] == n_blocks


def test_bn_writes_running_stats_once_per_forward():
    """One train forward and backward under remat moves each BN's running
    mean by one momentum step: the recompute in the backward writes nothing."""
    cfg = tiny_cfg(True, mode="off")
    critic = vt.build_models(cfg, device="cpu")[1]
    x = torch.rand(BATCH, SIZE, SIZE, 1)
    bn = critic.res_layers[0][0].bn2
    before = bn.running_mean.clone()
    u_before = critic.res_layers[0][0].conv1.weight_u.clone()
    g = torch.Generator().manual_seed(0)
    critic(x, train=True, generator=g).sum().backward()
    once = bn.running_mean.clone()
    assert not torch.equal(once, before)
    # the same forward again without remat from the same state moves it as far
    critic2 = vt.build_models(tiny_cfg(False, mode="off"), device="cpu")[1]
    critic2(x, train=True, generator=torch.Generator().manual_seed(0)).sum().backward()
    assert torch.equal(critic2.res_layers[0][0].bn2.running_mean, once)
    assert torch.equal(critic2.res_layers[0][0].conv1.weight_u,
                       critic.res_layers[0][0].conv1.weight_u)
    assert not torch.equal(critic.res_layers[0][0].conv1.weight_u, u_before)


@pytest.mark.parametrize("channelwise", [False, True])
def test_remat_tape_keeps_the_local_bool_mask(monkeypatch, channelwise):
    """Under remat a Dropout keeps its mask on the block's tape until the
    backward. In a data-parallel step the mask is drawn in float32 for the
    global batch and cut to this process's rows; the tape must hold those
    rows alone, as a bool tensor with a storage of its own (one byte an
    element of the local mask), and the output must be the one without
    remat."""
    tapes = []

    class Recording(layers.Tape):
        def __init__(self):
            super().__init__()
            tapes.append(self)

    monkeypatch.setattr(layers, "Tape", Recording)
    drop = layers.Dropout(0.5, channelwise=channelwise)
    x = torch.rand(2, 3, 4, 4, requires_grad=True)
    replica = Replica(rank=1, world=2)
    kw = dict(train=True, replica=replica)
    y = layers.remat(drop, x, generator=torch.Generator().manual_seed(0), **kw)
    (mask,) = tapes[0].entries.values()
    local = (2, 3, 1, 1) if channelwise else tuple(x.shape)
    assert mask.dtype == torch.bool and tuple(mask.shape) == local
    assert mask.untyped_storage().nbytes() == mask.numel()
    assert torch.equal(y, drop(x, generator=torch.Generator().manual_seed(0), **kw))
    y.sum().backward()
    assert torch.equal(x.grad, torch.where(mask, 2.0, 0.0).expand_as(x))


# ---------------------------------------------------------------------------
# the plain versions with an index base
# ---------------------------------------------------------------------------

def _nchw(n, c, h, w, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, h, w, c), generator=g).to(dtype).permute(0, 3, 1, 2)


@pytest.mark.parametrize("base_rows", [1, 3])
def test_dropout_slice_of_the_global_draw(base_rows):
    """Rows [r, r + 2) of a (6, 12, 3, 5) draw are the draw of a (2, 12, 3, 5)
    tensor with base r * 12 * 3 * 5."""
    full = _nchw(6, 12, 3, 5)
    part = full[base_rows:base_rows + 2]
    base = base_rows * part[0].numel()
    assert torch.equal(fused.keep_mask(part, 77, 0.5, base),
                       fused.keep_mask(full, 77, 0.5)[base_rows:base_rows + 2])
    assert torch.equal(fused.dropout_bits(part.numel(), 77, "cpu", base),
                       fused.dropout_bits(full.numel(), 77, "cpu")[base:base + part.numel()])
    c = part.shape[1]
    mean, var = torch.rand(c), torch.rand(c) + 0.5
    scale, bias = torch.rand(c), torch.rand(c)
    y_full = fused.bn_act_dropout_reference(full, mean, var, scale, bias, 77, 0.01, 0.5)
    y_part = fused.bn_act_dropout_reference(part, mean, var, scale, bias, 77, 0.01, 0.5,
                                            base=base)
    assert torch.equal(y_part, y_full[base_rows:base_rows + 2])
    g = _nchw(6, 12, 3, 5, seed=1)
    dx_full = fused.bn_act_dropout_backward_reference(full, g, mean, var, scale, bias, 77,
                                                      0.01, 0.5)[0]
    dx_part = fused.bn_act_dropout_backward_reference(part, g[base_rows:base_rows + 2], mean,
                                                      var, scale, bias, 77, 0.01, 0.5,
                                                      base=base)[0]
    assert torch.equal(dx_part, dx_full[base_rows:base_rows + 2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reparam_slice_of_the_global_draw(dtype):
    full_mu, full_lv = _nchw(4, 8, 2, 2, 2, dtype), _nchw(4, 8, 2, 2, 3, dtype) * 0.1
    base = 3 * full_mu[0].numel()
    eps_full = fused.reparam_noise(full_mu.shape, 9, "cpu")
    eps_part = fused.reparam_noise(full_mu[3:].shape, 9, "cpu", base)
    assert torch.equal(eps_part, eps_full[3:])
    z_full, _ = fused.reparam_kl_reference(full_mu, full_lv, 9)
    z_part, _ = fused.reparam_kl_reference(full_mu[3:], full_lv[3:], 9, base)
    assert torch.equal(z_part, z_full[3:])
    gz = _nchw(4, 8, 2, 2, 4, dtype)
    d_full = fused.reparam_kl_backward_reference(full_mu, full_lv, gz, None, 9)
    d_part = fused.reparam_kl_backward_reference(full_mu[3:], full_lv[3:], gz[3:], None, 9,
                                                 base)
    for a, b in zip(d_part, d_full):
        assert torch.equal(a, b[3:])


def test_base_must_be_a_multiple_of_four():
    x = _nchw(1, 3, 1, 1)
    with pytest.raises(ValueError, match="multiple of 4"):
        fused.keep_mask(x, 1, 0.5, base=6)
    with pytest.raises(ValueError, match="multiple of 4"):
        fused.reparam_kl_forward(x, x, 1, base=2)
    with pytest.raises(ValueError, match="multiple of 4"):
        fused.bn_act_dropout_forward(x.contiguous(memory_format=torch.channels_last),
                                     *(torch.ones(3),) * 4, 1, 0.01, 0.5, base=-4)
