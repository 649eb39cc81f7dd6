"""Write the Orbax checkpoints of ``tests/data/orbax/`` with the JAX package.

    JAX_PLATFORMS=cpu python tests/make_orbax_fixtures.py [--out tests/data/orbax]

Each fixture is a TrainState after two steps of the JAX package's train loop
(``vaegan_tpu.train.loop.train``) on synthetic data, at the small widths of the
port's step tests (32², batch 2, a depth-1 generator of feature size 4, a
narrow critic):

- ``rmsprop_ema``: the ``notebook`` preset (two optimizers, RMSprop, WGAN-GP)
  with a generator EMA of decay 0.999;
- ``three``: the ``vaegan_paper`` preset (three optimizers, RMSprop, BCE and
  feature matching), no EMA.

A fixture's directory holds ``checkpoint/`` (the ``CheckpointManager``
directory, with step ``2/``), ``config.json`` (``Config.to_json``; no paths)
and ``leaves.json``: each leaf's key path, dtype, shape and the sha256 of its
C-order bytes as ``orbax`` restores it (None leaves listed with a null dtype).
``tests/test_torch_orbax.py`` holds these files to a fresh ``orbax`` restore
and to the port's reader; ``chip_smoke.py`` reads them on the card, which has
no JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:        # run as a script from anywhere: the JAX package is at the root
    sys.path.insert(0, ROOT)

FIXTURES = ("rmsprop_ema", "three")
STEPS = 2
SIZE, BATCH = 32, 2


def config(name: str):
    from vaegan_tpu.config import preset

    jcfg = preset("notebook" if name == "rmsprop_ema" else "vaegan_paper")
    return jcfg.replace(
        generator=jcfg.generator.replace(depth=1, length=1, feature_size=4),
        discriminator=jcfg.discriminator.replace(
            num_features_conv1=8, num_blocks=(1, 1), num_strides_res=(1, 2),
            num_features_res=(8, 16), linear_widths=(16, 8)),
        data=jcfg.data.replace(image_size=SIZE, batch_size=BATCH, synthetic=True,
                               synthetic_size=STEPS * BATCH),
        train=jcfg.train.replace(
            n_epochs=1, max_steps=None, sample_interval=0, sample_dir="samples",
            checkpoint_dir=None, checkpoint_every=0, use_pallas="off",
            ema_decay=0.999 if name == "rmsprop_ema" else None))


def leaves(tree) -> list:
    """``[{"path", "dtype", "shape", "sha256"}]`` of every leaf of ``tree``,
    None leaves included, in the order of ``jax.tree_util``'s flattening."""
    import jax
    import numpy as np

    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: x is None)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k)))) for k in path]
        if leaf is None:
            out.append({"path": keys, "dtype": None, "shape": None, "sha256": None})
            continue
        a = np.asarray(leaf)
        out.append({"path": keys, "dtype": str(a.dtype), "shape": list(a.shape),
                    "sha256": hashlib.sha256(a.tobytes()).hexdigest()})   # C order
    return out


def restore_raw(directory: str):
    """The latest step under ``directory`` as ``orbax`` restores it without a
    template (mappings and lists)."""
    import orbax.checkpoint as ocp

    mgr = ocp.CheckpointManager(os.path.abspath(directory))
    try:
        return mgr.restore(mgr.latest_step(), args=ocp.args.StandardRestore())
    finally:
        mgr.close()


def write(name: str, out: str) -> None:
    from vaegan_tpu.train.loop import train

    cfg = config(name)
    dest = os.path.join(out, name)
    shutil.rmtree(dest, ignore_errors=True)
    os.makedirs(dest)
    with tempfile.TemporaryDirectory() as tmp:
        run = cfg.replace(train=cfg.train.replace(
            checkpoint_dir=os.path.join(tmp, "ck"), sample_dir=os.path.join(tmp, "samples")))
        state, _ = train(run)
        assert int(state.step) == STEPS
        shutil.copytree(os.path.join(tmp, "ck"), os.path.join(dest, "checkpoint"))
    with open(os.path.join(dest, "config.json"), "w") as f:
        f.write(cfg.to_json())
    with open(os.path.join(dest, "leaves.json"), "w") as f:
        rows = leaves(restore_raw(os.path.join(dest, "checkpoint")))
        f.write("[\n" + ",\n".join(json.dumps(r) for r in rows) + "\n]\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(os.path.dirname(__file__), "data", "orbax"))
    args = ap.parse_args(argv)
    for name in FIXTURES:
        write(name, args.out)
        print(f"wrote {os.path.join(args.out, name)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
