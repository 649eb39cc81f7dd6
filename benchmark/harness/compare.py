"""The numbers that decide ``correct``: what the timed path produced, held to
the plain reference.

Training. The program's first steps run in set-up through the window's own
call and feed. Step 1 starts from the weights the benchmark made, so the
reference computes it on its own. Steps 2 and 3 of a GAN cannot be followed so:
two sound runs part within a few steps (cuDNN's run-to-run choices, the
critic's clamp), so the reference starts each of them from the program's state
after the step before, and the hand-over itself is what step 1 checks. Every
number is then one step's disagreement, whatever the window did after it:

- ``feed_gap``: largest difference between a batch the program consumed and
  the rows the reference draws from the loader's seed (exact: 0);
- ``loss_gap``: the two optimizers' losses, |program - reference| / |reference|,
  worst over the three steps (and each alone, ``d_loss_gap``, ``g_loss_gap``);
- ``grad_gap``: the gradient each optimizer got at step 1 (the program's worked
  out from its RMSprop square average, sqrt(s / (1 - alpha))), the gap of the
  two norms of each leaf over the larger of the reference's norm of that leaf
  and of the network's median leaf, worst leaf;
- ``change_gap``: the same measure of each leaf's change in each step, the EMA's
  leaves included; a leaf whose reference gradient is under a thousandth of the
  network's median leaf's (a bias that batch norm cancels, the last bias under
  the WGAN loss) moves by round-off alone under RMSprop and is left out;
- ``ema_gap`` (a configuration with a generator EMA): the EMA's update
  held by itself, from the program's own parameters after each step, over
  all its leaves together;
- ``state_gap``: the BN running statistics and the spectral vectors,
  ||program - reference|| over the larger of ||reference|| and the network's
  median buffer's, worst buffer and step.

``grad_gap_median`` and ``state_gap_median`` are the median over the leaves
(or buffers, and steps): steady from seed to seed where the worst leaf swings
with round-off (see ``PERF.md``). ``change_gap_median`` is the median leaf's
change gap of each step and network (generator, critic, EMA), worst of those:
a fault in one network's update or clamp moves its median whole. A cell's
limits file says which numbers it holds. ``details`` also gives, for the
worst leaf of the change, the reference's gradient of that leaf at that step
over the median leaf's: a leaf whose gradient is all but nought takes a full
RMSprop step of whatever its round-off says.

Serving: ``recon_gap``, the largest difference of a sampled call's
reconstruction over the reference's largest magnitude, and ``mse_gap``, the
relative gap of the call's reported MSE.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional

import torch

Snap = Dict[str, object]

LOSSES = ("d_loss", "g_loss")
SKIP_BUFFERS = ("num_batches_tracked",)
NOUGHT = 1e-3


def _median(values) -> float:
    """The median; infinite where any value is not finite (a NaN does not
    sort, so a median over one could hide it)."""
    values = list(values)
    if not all(math.isfinite(v) for v in values):
        return math.inf
    return statistics.median(values)


def _norms(t: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in t.items()}


def _worst(gaps: Dict[str, float]):
    if not gaps:
        return 0.0, None
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], keep=None) -> Dict[str, float]:
    """|prog - ref| / max(ref, median ref) per leaf (of ``keep``)."""
    keys = [k for k in ref if keep is None or k in keep]
    if not keys:
        return {}
    med = statistics.median(ref[k] for k in keys)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys}


def grad_from_square_avg(sq: Dict[str, torch.Tensor], alpha: float) -> Dict[str, float]:
    """Norms of the first gradients an RMSprop optimizer took, from its square
    averages after that one step."""
    return {k: math.sqrt(float(v.double().sum()) / (1.0 - alpha)) for k, v in sq.items()}


def _moved(after: Dict[str, torch.Tensor], before: Dict[str, torch.Tensor]):
    return {k: float((after[k].double() - before[k].double()).norm()) for k in after}


def train_checks(cfg: dict, starts: List[Snap], progs: List[Snap], refs: List[Snap],
                 ref_batches: List[torch.Tensor]) -> Dict[str, object]:
    """Readings of the program's steps ``progs`` (step k from ``starts[k]``)
    against the reference's ``refs`` from the same starts. A snapshot holds
    ``batch``, ``losses``, ``gp``/``gb``/``dp``/``db`` (generator and critic
    parameters and buffers), ``g_sq``/``d_sq`` and ``ema``; a reference one also
    ``g_grads``/``d_grads``."""
    alpha = cfg["optim"]["rms_decay"]
    out: Dict[str, object] = {}
    out["feed_gap"] = max(float((p["batch"].float() - b.float().cpu()).abs().max())
                          for p, b in zip(progs, ref_batches))
    step_losses = []
    for p, r in zip(progs, refs):
        step_losses.append({k: abs(p["losses"][k] - r["losses"][k]) / max(abs(r["losses"][k]),
                                                                           1e-30)
                            for k in LOSSES})
    out["loss_gap"] = max(max(s.values()) for s in step_losses)
    for k in LOSSES:
        out[f"{k}_gap"] = max(s[k] for s in step_losses)

    grads = {}
    for net, sq in (("g", "g_sq"), ("d", "d_sq")):
        grads.update({f"{net}.{k}": v for k, v in _leaf_gaps(
            grad_from_square_avg(progs[0][sq], alpha), _norms(refs[0][f"{net}_grads"])).items()})
    out["grad_gap"], grad_leaf = _worst(grads)
    out["grad_gap_median"] = _median(grads.values())

    changes, groups, left_out, why = {}, {}, set(), {}
    for step, (s, p, r) in enumerate(zip(starts, progs, refs), start=1):
        for net in ("g", "d"):
            gnorm = _norms(r[f"{net}_grads"])
            med = statistics.median(gnorm.values())
            keep = {k for k, v in gnorm.items() if v >= NOUGHT * med}
            left_out |= {f"{net}.{k}" for k in gnorm if k not in keep}
            why.update({f"{step}.{net}.{k}": gnorm[k] / max(med, 1e-30) for k in keep})
            parts = [(net, _leaf_gaps(_moved(p[f"{net}p"], s[f"{net}p"]),
                                      _moved(r[f"{net}p"], s[f"{net}p"]), keep))]
            if net == "g" and r.get("ema") is not None:
                parts.append(("ema", _leaf_gaps(_moved(p["ema"], s["ema"]),
                                                _moved(r["ema"], s["ema"]), keep)))
            for name, gaps in parts:
                changes.update({f"{step}.{name}.{k}": v for k, v in gaps.items()})
                groups[f"{step}.{name}"] = _median(gaps.values())
    out["change_gap"], change_leaf = _worst(changes)
    out["change_gap_median"] = max(groups.values())

    states = {}
    for step, (p, r) in enumerate(zip(progs, refs), start=1):
        for net in ("g", "d"):
            bufs = {k: v for k, v in r[f"{net}b"].items() if not k.endswith(SKIP_BUFFERS)}
            ref = _norms(bufs)
            diff = {k: float((p[f"{net}b"][k].double() - v.double()).norm())
                    for k, v in bufs.items()}
            med = statistics.median(ref.values())
            states.update({f"{step}.{net}.{k}": diff[k] / max(ref[k], med, 1e-30)
                           for k in bufs})
    if progs[0].get("ema") is not None:
        out["ema_gap"] = _ema_gap(cfg["train"]["ema_decay"], starts, progs)
    out["state_gap"], state_leaf = _worst(states)
    out["state_gap_median"] = _median(states.values())
    out["details"] = {
        "step_loss_gaps": [max(s.values()) for s in step_losses],
        "grad_worst_leaf": grad_leaf, "change_worst_leaf": change_leaf,
        "state_worst_buffer": state_leaf, "change_left_out": len(left_out),
        "change_medians": groups,
        "change_worst_leaf_grad": why.get((change_leaf or "").replace(".ema.", ".g.", 1)),
        "grad_top": sorted(grads.items(), key=lambda kv: -kv[1])[:5],
        "change_top": sorted(changes.items(), key=lambda kv: -kv[1])[:5],
    }
    return out


def _ema_gap(decay: float, starts: List[Snap], progs: List[Snap]) -> float:
    """Worst step of ||EMA_k - (d EMA_(k-1) + (1 - d) p_k)|| over
    ||d EMA_(k-1) + (1 - d) p_k - EMA_(k-1)||, over all the EMA's leaves
    together, with the program's own parameters p_k: the EMA's update held by
    itself (a skipped update reads 1). One leaf alone would read the float32
    rounding of the EMA itself: a BN weight near 1 moves by ~1e-6 a step."""
    worst = 0.0
    for s, p in zip(starts, progs):
        off = moved = 0.0
        for k, e in p["ema"].items():
            before = s["ema"][k].double()
            want = decay * before + (1.0 - decay) * p["gp"][k].double()
            off += float((e.double() - want).square().sum())
            moved += float((want - before).square().sum())
        worst = max(worst, math.sqrt(off / max(moved, 1e-60)))
    return worst


def serve_checks(progs: List[Snap], refs: List[Snap]) -> Dict[str, object]:
    """Readings of sampled reconstruct calls (``recon``, ``mse``) against the
    reference's."""
    recon = mse = 0.0
    for p, r in zip(progs, refs):
        scale = float(r["recon"].abs().max())
        recon = max(recon, float((p["recon"].float() - r["recon"].float()).abs().max())
                    / max(scale, 1e-30))
        mse = max(mse, abs(p["mse"] - r["mse"]) / max(abs(r["mse"]), 1e-30))
    return {"recon_gap": recon, "mse_gap": mse, "details": {"calls_compared": len(progs)}}


def verdict(readings: Dict[str, object], limits: Dict[str, float]) -> Optional[Dict[str, dict]]:
    """``{name: {"value", "limit"}}`` of every limited number; None if a
    limited number is missing."""
    out = {}
    for k, lim in limits.items():
        if k not in readings:
            return None
        out[k] = {"value": float(readings[k]), "limit": float(lim)}
    return out


def passed(checks: Dict[str, dict]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
