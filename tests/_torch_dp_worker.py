"""One process of a data-parallel run of the port over gloo, for
``tests/test_torch_parallel.py`` (not a test module).

    python tests/_torch_dp_worker.py RANK WORLD STORE_DIR PLAN OUT

joins a gloo process group of WORLD processes through a file store in
STORE_DIR, runs every case of the ``torch.save``d PLAN on its rows of each
global batch (``parallel.make_parallel_train_step``) and saves what
:func:`run` returns per case to OUT. The tests run the same :func:`run` with
no mesh for the one-process step on the global batch.

A case is a dict: ``cfg`` (``Config.to_dict()``), ``init`` (None, or state
dicts to start from), ``steps`` (a list of ``(do_g_update, global batch,
seed, inject or None)``).
"""

from __future__ import annotations

import os
import sys

import torch

torch.set_num_threads(1)


def _recording(opt, module, store: dict) -> None:
    """Keep the gradients each ``opt.step`` applies, by parameter name."""
    named = list(module.named_parameters())
    inner = opt.step

    def step(*a, **k):
        store.clear()
        store.update({n: p.grad.detach().clone() for n, p in named})
        return inner(*a, **k)

    opt.step = step


def _square_avg(opt, module) -> dict:
    return {n: opt.state[p]["square_avg"].clone() for n, p in module.named_parameters()
            if p in opt.state}


def run(case: dict, mesh=None) -> dict:
    """Run a case's steps; the mesh's data-parallel step, or the one-process
    step on the global batch without one. Returns per step the metrics, the
    gradients each optimizer applied and (one process) the generator's fused
    draws, and at the end both modules' state dicts, the RMSprop state and the
    EMA."""
    import vaegan_tpu_torch as vt
    from vaegan_tpu_torch.parallel import make_parallel_train_step, replicate_state, shard_batch
    from vaegan_tpu_torch.train import fused_draws

    cfg = vt.Config.from_dict(case["cfg"])
    state = vt.create_train_state(cfg, device="cpu")
    if case.get("init"):
        state.generator.load_state_dict(case["init"]["generator"])
        state.critic.load_state_dict(case["init"]["critic"])
    if mesh is not None:
        replicate_state(state, mesh)
    g_rec, d_rec = {}, {}
    _recording(state.opt_g, state.generator, g_rec)
    _recording(state.opt_d, state.critic, d_rec)
    paper = cfg.optim.scheme == "three"
    steps = []
    for do_g, batch, seed, inject in case["steps"]:
        if mesh is not None:
            step = make_parallel_train_step(cfg, mesh, do_g, inject=inject)
            batch = shard_batch(mesh, batch, cfg.train.grad_accum)
        elif paper:
            step = vt.make_paper_train_step(cfg, inject=inject)
        else:
            step = vt.make_train_step(cfg, do_g, inject=inject)
        g_rec.clear()
        state, metrics = step(state, batch, seed)
        steps.append({"metrics": {k: float(v) for k, v in metrics.items()},
                      "g_grads": dict(g_rec) or None, "d_grads": dict(d_rec),
                      "draws": fused_draws(state.generator) if cfg.train.grad_accum == 1
                      else None})
    return {"steps": steps,
            "generator": {k: v.clone() for k, v in state.generator.state_dict().items()},
            "critic": {k: v.clone() for k, v in state.critic.state_dict().items()},
            "nu_g": _square_avg(state.opt_g, state.generator),
            "nu_d": _square_avg(state.opt_d, state.critic),
            "ema": {k: v.clone() for k, v in (state.g_ema or {}).items()}}


def main(rank: int, world: int, store_dir: str, plan: str, out: str) -> None:
    from vaegan_tpu_torch.parallel import dist, make_mesh

    dist.initialize(backend="gloo", init_method=f"file://{store_dir}/store",
                    world_size=world, rank=rank, device="cpu", timeout_s=120)
    try:
        mesh = make_mesh()
        results = {name: run(case, mesh) for name, case in torch.load(plan).items()}
        torch.save(results, f"{out}.tmp")
        os.replace(f"{out}.tmp", out)
    finally:
        dist.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
