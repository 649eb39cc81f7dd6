"""Entry point of the port (the counterpart of ``__graft_entry__.py``'s
``entry()``).

``entry(device="cuda")`` returns ``(forward, example_args)``: the flagship
``notebook`` generator (depth 2, length 1, feature_size 64) at 96², batch 4, in
eval mode, built as the serving path builds it (``build_generator``, weights
from seed 0) with ``use_pallas="all"``, so that its 12 BN sites run the
``bn_act_dropout`` kernel on a CUDA device. ``forward(generator, batch)``
returns the reconstruction; ``example_args`` is ``(generator, zeros (4, 96, 96,
1))`` on ``device``.

``__graft_entry__.py``'s ``dryrun_multichip(n)`` (the data-parallel step over
an n-device mesh) waits for multi-device training in the port (ROADMAP.md
A.7).
"""

from __future__ import annotations

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
