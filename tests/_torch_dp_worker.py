"""One process of a parallel run of the port over gloo, for
``tests/test_torch_parallel.py`` and ``tests/test_torch_parallel_2d.py`` (not
a test module).

    python tests/_torch_dp_worker.py RANK WORLD STORE_DIR PLAN OUT [NUM_MODEL [MEMBERS]]

joins a gloo process group of WORLD processes through a file store in
STORE_DIR, makes the mesh WORLD / NUM_MODEL x NUM_MODEL (default 1), runs
every case of the ``torch.save``d PLAN on its part of each global batch
(``parallel.make_parallel_train_step``) and saves what :func:`run` returns per
case to OUT. With MEMBERS (global ranks, comma-separated) the mesh spans the
group of those processes (``make_mesh(group=...)``); a process outside it
saves no results. The tests run the same :func:`run` with no mesh for the
one-process step on the global batch.

A case is a dict: ``cfg`` (``Config.to_dict()``), ``init`` (None, or state
dicts to start from), ``steps`` (a list of ``(do_g_update, global batch,
seed, inject or None)``), and optionally ``tp`` (split the critic head over
the model axis, ``parallel.shard_state``), ``spatial`` (split H over it),
``save`` (a directory to save the final state to, every process taking part;
``{process}`` in it stands for the process's global rank)
and ``load`` (a directory whose latest checkpoint is then restored into the
state, its critic and RMSprop state returned as ``loaded``). A case with
``forward`` (a global NHWC batch) instead runs the eval-mode generator on it,
split like a spatial step's batch, and returns the reconstruction.
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


def _forward(case: dict, mesh) -> dict:
    """The eval-mode generator's reconstruction of ``case["forward"]``, this
    process's rows and stripe of it on a mesh."""
    import vaegan_tpu_torch as vt
    from vaegan_tpu_torch.parallel import BatchSpec, shard_batch

    cfg = vt.Config.from_dict(case["cfg"])
    gen = vt.train.state.build_generator(cfg, device="cpu", seed=1)
    x, replica = case["forward"], vt.ops.replica.LOCAL
    if mesh is not None:
        spec = BatchSpec(spatial=True)
        x, replica = shard_batch(mesh, x, spec=spec), mesh.replica_for(True)
    with torch.no_grad():
        return {"forward": gen(x, train=False, replica=replica)[0]}


def run(case: dict, mesh=None) -> dict:
    """Run a case's steps; the mesh's parallel step, or the one-process step
    on the global batch without one. Returns per step the metrics, the
    gradients each optimizer applied and (one process) the generator's fused
    draws, and at the end both modules' state dicts, the RMSprop state and the
    EMA."""
    import vaegan_tpu_torch as vt
    from vaegan_tpu_torch.checkpoint import CheckpointManager
    from vaegan_tpu_torch.parallel import (
        BatchSpec,
        make_parallel_train_step,
        replicate_state,
        shard_batch,
        shard_state,
    )
    from vaegan_tpu_torch.train import fused_draws

    if case.get("forward") is not None:
        return _forward(case, mesh)
    cfg = vt.Config.from_dict(case["cfg"])
    state = vt.create_train_state(cfg, device="cpu")
    if case.get("init"):
        state.generator.load_state_dict(case["init"]["generator"])
        state.critic.load_state_dict(case["init"]["critic"])
    spec = BatchSpec(spatial=bool(case.get("spatial")))
    if mesh is not None:
        (shard_state if case.get("tp") else replicate_state)(state, mesh)
    g_rec, d_rec = {}, {}
    _recording(state.opt_g, state.generator, g_rec)
    _recording(state.opt_d, state.critic, d_rec)
    paper = cfg.optim.scheme == "three"
    steps = []
    for do_g, batch, seed, inject in case["steps"]:
        if mesh is not None:
            step = make_parallel_train_step(cfg, mesh, do_g, inject=inject, batch_spec=spec)
            batch = shard_batch(mesh, batch, cfg.train.grad_accum, spec)
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
    out = {}
    if case.get("save"):
        CheckpointManager(case["save"].format(process=0 if mesh is None else mesh.global_rank)).save(
            state, replica=vt.ops.replica.LOCAL if mesh is None else mesh.replica)
    if case.get("load"):
        loaded = CheckpointManager(case["load"]).restore(
            vt.create_train_state(cfg, device="cpu") if mesh is None else
            shard_state(vt.create_train_state(cfg, device="cpu"), mesh))
        out["loaded"] = {"critic": {k: v.clone() for k, v in loaded.critic.state_dict().items()},
                         "nu_d": _square_avg(loaded.opt_d, loaded.critic)}
    return {**out, "steps": steps,
            "generator": {k: v.clone() for k, v in state.generator.state_dict().items()},
            "critic": {k: v.clone() for k, v in state.critic.state_dict().items()},
            "nu_g": _square_avg(state.opt_g, state.generator),
            "nu_d": _square_avg(state.opt_d, state.critic),
            "ema": {k: v.clone() for k, v in (state.g_ema or {}).items()}}


def main(rank: int, world: int, store_dir: str, plan: str, out: str,
         num_model: int = 1, members: str = "") -> None:
    from vaegan_tpu_torch.parallel import dist, make_mesh

    dist.initialize(backend="gloo", init_method=f"file://{store_dir}/store",
                    world_size=world, rank=rank, device="cpu", timeout_s=120)
    try:
        group = (torch.distributed.new_group([int(r) for r in members.split(",")])
                 if members else None)
        mesh = make_mesh(num_model=num_model, group=group)
        results = ({} if mesh is None else
                   {name: run(case, mesh) for name, case in torch.load(plan).items()})
        torch.save(results, f"{out}.tmp")
        os.replace(f"{out}.tmp", out)
    finally:
        dist.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6],
         *(int(a) for a in sys.argv[6:7]), *sys.argv[7:8])
