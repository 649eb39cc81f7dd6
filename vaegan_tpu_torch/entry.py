"""Entry point of the port (the counterpart of ``__graft_entry__.py``'s
``entry()``).

``entry(device="cuda")`` returns ``(forward, example_args)``: the flagship
``notebook`` generator (depth 2, length 1, feature_size 64) at 96², batch 4, in
eval mode, built as the serving path builds it (``build_generator``, weights
from seed 0) with ``use_pallas="all"``, so that its 12 BN sites run the
``bn_act_dropout`` kernel on a CUDA device. ``forward(generator, batch)``
returns the reconstruction; ``example_args`` is ``(generator, zeros (4, 96, 96,
1))`` on ``device``.

``dryrun_multichip(n)`` (``__graft_entry__.py``'s) runs one parallel train
step of a tiny config over n processes on the CPU (gloo), each started as
``python -m vaegan_tpu_torch.entry --dryrun-child RANK N STORE``, and prints
rank 0's metrics. For even n >= 4 it runs the JAX dry run's mesh: data n/2 x
model 2, the critic head's kernels split over the model axis (tensor
parallelism) and the batch's H split over it too (spatial sharding); below
that, data n x model 1.
"""

from __future__ import annotations

import os
import sys
import tempfile
from pathlib import Path

import torch

from vaegan_tpu_torch.config import Config, preset
from vaegan_tpu_torch.inference import eval_reconstruct
from vaegan_tpu_torch.train.state import build_generator, resolve_device

IMAGE_SIZE, BATCH = 96, 4


def flagship_cfg(image_size: int = IMAGE_SIZE, batch_size: int = BATCH) -> Config:
    cfg = preset("notebook")
    return cfg.replace(data=cfg.data.replace(image_size=image_size, batch_size=batch_size),
                       train=cfg.train.replace(use_pallas="all"))


def entry(device="cuda"):
    dev = resolve_device(device)
    cfg = flagship_cfg()
    generator = build_generator(cfg, dev, seed=0)

    def forward(generator, batch):
        return eval_reconstruct(cfg, generator, batch)[0]

    example_args = (generator, torch.zeros((BATCH, IMAGE_SIZE, IMAGE_SIZE, 1), device=dev))
    return forward, example_args


def _dryrun_cfg(n: int) -> Config:
    base = Config()
    return base.replace(
        generator=base.generator.replace(depth=1, length=1, feature_size=8),
        discriminator=base.discriminator.replace(
            num_stride_conv1=1, num_features_conv1=8, num_blocks=(1, 1),
            num_strides_res=(1, 2), num_features_res=(16, 16), pool_size=2,
            linear_widths=(16, 8, 8)),
        data=base.data.replace(image_size=16, batch_size=2 * n))


def _dryrun_child(rank: int, n: int, store: str) -> None:
    from vaegan_tpu_torch.parallel import (
        batch_sharding,
        dist,
        make_mesh,
        make_parallel_train_step,
        shard_batch,
        shard_state,
    )
    from vaegan_tpu_torch.train.state import create_train_state

    torch.set_num_threads(1)
    dist.initialize(backend="gloo", init_method=f"file://{store}", world_size=n, rank=rank,
                    device="cpu", timeout_s=300)
    try:
        cfg = _dryrun_cfg(n)
        n_model = 2 if n >= 4 and n % 2 == 0 else 1
        mesh = make_mesh(num_data=n // n_model, num_model=n_model)
        state = shard_state(create_train_state(cfg, device="cpu", seed=0), mesh)
        bsh = batch_sharding(mesh, spatial_axis="model" if n_model > 1 else None)
        step = make_parallel_train_step(cfg, mesh, do_g_update=True, batch_spec=bsh)
        batch = torch.rand((2 * n, 16, 16, 1), generator=torch.Generator().manual_seed(1))
        state, metrics = step(state, shard_batch(mesh, batch, spec=bsh), 2)
        assert state.step == 1
        values = {k: float(v) for k, v in metrics.items()}
        bad = [k for k, v in values.items() if v != v]
        if bad:
            raise RuntimeError(f"non-finite metrics {bad}")
        if rank == 0:
            what = "dp + critic-head tp + spatial sharding" if n_model > 1 else "dp"
            print(f"dryrun_multichip({n}) ok (mesh data={mesh.num_data} x "
                  f"model={mesh.num_model}, {what}; {n} gloo processes):",
                  {k: round(v, 3) for k, v in values.items()}, flush=True)
    finally:
        dist.shutdown()


def dryrun_multichip(n_devices: int, timeout_s: float = 600.0) -> None:
    """One data-parallel step over ``n_devices`` CPU processes (module
    docstring); raises if any process fails or the run outlasts ``timeout_s``."""
    from vaegan_tpu_torch.parallel import dist

    with tempfile.TemporaryDirectory(prefix="vaegan_dryrun_") as tmp:
        res = dist.run_processes(
            [[sys.executable, "-m", "vaegan_tpu_torch.entry", "--dryrun-child", str(r),
              str(n_devices), os.path.join(tmp, "store")] for r in range(n_devices)],
            timeout_s, cwd=str(Path(__file__).resolve().parents[1]))
    sys.stdout.write(res[0][1])
    failed = [r for r, (rc, _, _) in enumerate(res) if rc != 0]
    if failed:
        sys.stderr.write("".join(res[r][2] for r in failed))
        raise RuntimeError(f"dryrun_multichip({n_devices}): processes {failed} failed")


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--dryrun-child":
        _dryrun_child(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    else:
        sys.exit("usage: python -m vaegan_tpu_torch.entry --dryrun-child RANK N STORE")
