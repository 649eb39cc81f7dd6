"""The port's Larsen Algorithm-1 step, ``make_paper_train_step``, against the
benchmark's plain reference of it, ``benchmark/reference/paper.py``, on the CPU
at 32², batch 2, with narrowed widths and the port's own seeded weights.

Three steps from one start, each on its own batch and step seed: the three
losses (enc_l and dec_l from the step's metrics, dis_l = ``d_loss``), each
group's gradients as its optimizer took them (weight decay included), and
after each step every parameter, buffer (BN running statistics, spectral u and
v), RMSprop square average and the EMA. ``use_pallas="all"`` runs the kernels'
plain versions (the critic fused too, at p = 0) and draws as the reference
does; ``"off"`` draws the generator's dropout and noise from the device
generator, so the reference's draws (Philox from the kernel seeds) are injected
into it. Both leave the device generator to z_p and the critic's channel
dropout, which the reference draws in the same order.

Tolerances, each with its reason (the program's readings here are under a
fifth of each, the EMA's under half by construction):
- losses: 1e-5 relative. The two sum the convolutions in other orders
  (channels-last and the fused BN's plain version against contiguous
  ``F.batch_norm``): float32 round-off, ~1e-7 here.
- gradients: each tensor within 1e-4 of its own largest element plus 1e-5
  of its group's largest. Round-off through three critic forwards reads
  ~1e-6 of a tensor; a BN weight or bias whose terms cancel holds only noise
  on the scale of its terms, hence the group's share.
- RMSprop's root square averages: as the gradients (they are gradients'
  magnitudes).
- buffers: 5e-5 of each buffer's largest element (running statistics of
  activations that carry the gradients' round-off, spectral vectors).
- each parameter tensor's change in the step: 3e-2 of the reference's change
  by norm, as the benchmark's ``change_gap``. RMSprop's first step moves every
  element by 10 lr whatever its gradient's size, so an element whose gradient
  sits at round-off flips a whole step; a tensor whose gradient is under a
  thousandth of its network's median tensor's moves by round-off alone and is
  left out.
- EMA: a few float32 roundings of itself plus twice (1 - decay) times the
  parameters' gap, since it moves by that share of them.

The reference computed with its TF32-like control (every convolution's and
linear layer's operands rounded to 10 mantissa bits) fails them.
"""

from __future__ import annotations

import statistics
import sys
from pathlib import Path

import pytest
import torch

import vaegan_tpu_torch as vt
from vaegan_tpu_torch.train import make_paper_train_step
from vaegan_tpu_torch.train import step as step_mod
from vaegan_tpu_torch.train.state import create_train_state

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.append(str(BENCH))

from reference import draws as rd  # noqa: E402
from reference import model as rm  # noqa: E402
from reference import paper as rp  # noqa: E402
from reference import train as rt  # noqa: E402

torch.set_num_threads(1)

SIZE, BATCH, STEPS = 32, 2, 3
LOSS_REL = 1e-5
GRAD_OWN, GRAD_GROUP = 1e-4, 1e-5
CHANGE_REL, NOUGHT = 3e-2, 1e-3
BUF_OWN = 5e-5
EMA_ULPS, EMA_GAPS, EPS32 = 4.0, 2.0, float(torch.finfo(torch.float32).eps)


def paper_cfg(mode: str) -> vt.Config:
    """``vaegan_paper`` at 32², batch 2, with narrowed widths (every kind of
    block kept: identity and projection shortcuts, all three conv modes)."""
    base = vt.preset("vaegan_paper")
    return base.replace(
        generator=base.generator.replace(depth=2, length=1, feature_size=4),
        discriminator=base.discriminator.replace(
            num_features_conv1=8, num_blocks=(1, 1, 1), num_strides_res=(1, 2, 2),
            num_features_res=(8, 16, 16), linear_widths=(16, 8)),
        data=base.data.replace(image_size=SIZE, batch_size=BATCH),
        train=base.train.replace(use_pallas=mode, seed=5))


def _split(sd: dict, spec) -> tuple:
    params = {n for n, _, k in spec if rm.is_param(k)}
    p = {k: v.detach().clone() for k, v in sd.items() if k in params}
    b = {k: v.detach().clone() for k, v in sd.items() if k not in params}
    return p, b


def _ref_state(state, cfg_d) -> rt.State:
    gp, gb = _split(state.generator.state_dict(), rm.generator_spec(cfg_d))
    dp, db = _split(state.critic.state_dict(), rm.critic_spec(cfg_d))
    ema = {k: v.clone() for k, v in state.g_ema.items()}
    return rt.State(gp, gb, dp, db, _square_avgs(state.opt_g, state.generator),
                    _square_avgs(state.opt_d, state.critic), ema)


def _square_avgs(opt, module) -> dict:
    return {k: opt.state[p]["square_avg"].clone() for k, p in module.named_parameters()
            if p in opt.state}


def generator_draws(cfg_d: dict, seed: int) -> dict:
    """The reference's generator draws of a step as an ``inject`` for the
    unfused port step: ``g_masks`` of the x~ forward, ``eps``, and
    ``g_masks_p`` of the prior decode, at each block's input shape."""
    g = cfg_d["generator"]
    blocks = rm.generator_blocks(g)
    n_enc = rm.n_encoder_blocks(g)
    seeds = iter(rd.site_seeds(seed, rm.n_draw_sites(cfg_d) + len(blocks) - n_enc))
    size = cfg_d["data"]["image_size"]
    shapes = []
    for _, mode, cin, _ in blocks:
        shapes.append((BATCH, cin, size, size))
        size = size // 2 if mode == "downsample" else size * 2 if mode == "upsample" else size
    p = g["dropout_prob"]
    masks = {}
    for (path, *_), shape in zip(blocks[:n_enc], shapes):
        masks[f"{path}.dropout"] = rd.keep_mask_nchw(shape, next(seeds), p, "cpu")
    latent = shapes[n_enc]
    eps = rd.noise_nchw(latent, next(seeds), "cpu").permute(0, 2, 3, 1)
    prior = {}
    for (path, *_), shape in zip(blocks[n_enc:], shapes[n_enc:]):
        masks[f"{path}.dropout"] = rd.keep_mask_nchw(shape, next(seeds), p, "cpu")
    for (path, *_), shape in zip(blocks[n_enc:], shapes[n_enc:]):
        prior[f"{path}.dropout"] = rd.keep_mask_nchw(shape, next(seeds), p, "cpu")
    return {"g_masks": masks, "eps": eps, "g_masks_p": prior}


def _batches():
    g = torch.Generator().manual_seed(11)
    return [torch.rand((BATCH, SIZE, SIZE, 1), generator=g) for _ in range(STEPS)]


def run_both(mode: str, precision: str = "fp32"):
    """Each step of the port and of the reference from the port's state before
    it: the configuration, the (port, reference) records and the starts."""
    cfg = paper_cfg(mode)
    cfg_d = cfg.to_dict()
    state = create_train_state(cfg, device="cpu")
    out, starts = [], []
    for k, batch in enumerate(_batches()):
        seed = rd.step_seed(cfg.train.seed, k)
        start = _ref_state(state, cfg_d)
        starts.append(start)
        inject = generator_draws(cfg_d, seed) if mode == "off" else None
        grads = []
        real = step_mod._paper_grads

        def record(groups, losses):
            gs = real(groups, losses)
            grads.append(gs)
            return gs

        step_mod._paper_grads = record
        try:
            state, metrics = make_paper_train_step(cfg, inject)(state, batch, seed)
        finally:
            step_mod._paper_grads = real
        ref = rp.step(cfg_d, start, batch, seed, precision)
        wd = cfg.optim.weight_decay
        named = dict(state.generator.named_parameters())
        enc, dec, _ = step_mod._paper_groups(state.generator, state.critic)
        by_id = {id(p): k for k, p in named.items()}
        g_taken = {by_id[id(p)]: g + wd * start.gp[by_id[id(p)]]
                   for p, g in zip(enc + dec, list(grads[0][0]) + list(grads[0][1]))}
        d_names = [k for k, _ in state.critic.named_parameters()]
        d_taken = {k: g + wd * start.dp[k] for k, g in zip(d_names, grads[0][2])}
        port = _port_record(cfg, state, metrics, g_taken, d_taken)
        out.append((port, _ref_record(ref)))
    return cfg, out, starts


def _port_record(cfg, state, metrics, g_taken, d_taken) -> dict:
    lc, m = cfg.loss, {k: float(v) for k, v in metrics.items()}
    enc_l = lc.kl_weight * m["kl"] + lc.reconstruction_weight * m["recon_loss"]
    gp, gb = _split(state.generator.state_dict(), rm.generator_spec(cfg.to_dict()))
    dp, db = _split(state.critic.state_dict(), rm.critic_spec(cfg.to_dict()))
    return {"losses": {"enc_l": enc_l, "dec_l": m["g_loss"] - enc_l, "dis_l": m["d_loss"]},
            "grads": {"g": g_taken, "d": d_taken}, "params": {"g": gp, "d": dp},
            "buffers": {"g": gb, "d": db},
            "sq": {"g": _square_avgs(state.opt_g, state.generator),
                   "d": _square_avgs(state.opt_d, state.critic)},
            "ema": {k: v.clone() for k, v in state.g_ema.items()}}


def _ref_record(r: rt.StepOut) -> dict:
    lo = {k: float(v) for k, v in r.losses.items()}
    s = r.state
    return {"losses": {"enc_l": lo["kl"] + lo["recon_loss"], "dec_l": lo["g_loss"]
                       - lo["kl"] - lo["recon_loss"], "dis_l": lo["d_loss"]},
            "grads": {"g": r.g_grads, "d": r.d_grads}, "params": {"g": s.gp, "d": s.dp},
            "buffers": {"g": s.gb, "d": s.db}, "sq": {"g": s.g_sq, "d": s.d_sq}, "ema": s.ema}


def _worst(got: dict, want: dict, tol, elementwise=None) -> tuple:
    """The largest ``|got - want| / tol(want)`` over the tensors (or over
    their elements, ``elementwise(key, want)`` giving each element's
    tolerance), and its key."""
    worst, at = 0.0, None
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            continue
        diff = (got[k].double() - w.double()).abs()
        r = float((diff / elementwise(k, w.double())).max() if elementwise else
                  diff.max() / tol(w))
        if r > worst:
            worst, at = r, k
    return worst, at


def gaps(cfg, records, starts) -> dict:
    """Each compared quantity's worst gap over the steps, as a share of its
    tolerance (1 is the tolerance), with the tensor and step where it is."""
    decay = cfg.train.ema_decay
    out = {}

    def keep(name, value, k):
        if value[0] >= out.get(name, (0.0,))[0]:
            out[name] = (*value, k)

    for k, ((port, ref), start) in enumerate(zip(records, starts)):
        for name, want in ref["losses"].items():
            keep(f"loss.{name}", (abs(port["losses"][name] - want) / (LOSS_REL * abs(want)),
                                  name), k)
        for net in ("g", "d"):
            grads = ref["grads"][net]
            top = max(float(v.abs().max()) for v in grads.values())
            keep(f"grad.{net}", _worst(port["grads"][net], grads, lambda w, top=top:
                                       GRAD_OWN * float(w.abs().max()) + GRAD_GROUP * top), k)
            rms = {n: v.sqrt() for n, v in ref["sq"][net].items()}
            top = max(float(v.max()) for v in rms.values())
            keep(f"rms.{net}", _worst({n: v.sqrt() for n, v in port["sq"][net].items()}, rms,
                                      lambda w, top=top: GRAD_OWN * float(w.max())
                                      + GRAD_GROUP * top), k)
            keep(f"buffer.{net}", _worst(port["buffers"][net], ref["buffers"][net],
                                         lambda w: BUF_OWN * float(w.abs().max())), k)
            keep(f"change.{net}", _change(start.gp if net == "g" else start.dp,
                                          port["params"][net], ref["params"][net], grads),
                 k)
        gap = {n: port["params"]["g"][n] - v for n, v in ref["params"]["g"].items()}
        keep("ema", _worst(port["ema"], ref["ema"], None, lambda n, w: (
            EMA_ULPS * EPS32 * w.abs().max() + EMA_GAPS * (1.0 - decay) * gap[n].abs())), k)
    return out


def _change(before, got, want, grads) -> tuple:
    """Each tensor's change in the step against the reference's,
    ``||port - ref|| / ||ref||`` over ``CHANGE_REL``, leaving out the tensors
    whose gradient is under ``NOUGHT`` of the network's median tensor's
    (they move by round-off alone)."""
    norms = {n: float(g.norm()) for n, g in grads.items()}
    med = statistics.median(norms.values())
    worst, at = 0.0, None
    for n, w in want.items():
        if norms[n] < NOUGHT * med:
            continue
        d_ref, d_got = w - before[n], got[n] - before[n]
        r = float((d_got - d_ref).norm()) / (CHANGE_REL * float(d_ref.norm()))
        if r > worst:
            worst, at = r, n
    return worst, at


@pytest.mark.parametrize("mode", ["off", "all"])
def test_the_paper_step_matches_its_plain_reference(mode):
    cfg, records, starts = run_both(mode)
    got = gaps(cfg, records, starts)
    over = {k: v for k, v in got.items() if v[0] > 1.0}
    assert not over, over
    # every group moved, so the comparison held something
    assert all(float(v.abs().max()) > 0 for r in records for v in r[1]["grads"]["g"].values())


def test_the_tf32_control_fails_the_tolerances():
    cfg, records, starts = run_both("all", "tf32")
    got = gaps(cfg, records, starts)
    assert max(v[0] for v in got.values()) > 1.0, got


def test_the_reference_refuses_the_two_optimizer_step():
    cfg_d = vt.preset("notebook").to_dict()
    st = rt.State({}, {}, {}, {})
    with pytest.raises(ValueError, match="Algorithm 1"):
        rp.step(cfg_d, st, torch.zeros((1, 8, 8, 1)), 0)
