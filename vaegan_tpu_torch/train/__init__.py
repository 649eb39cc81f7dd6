"""Train state, step and loop. The package is itself callable:
``vaegan_tpu_torch.train(cfg, ...)`` is :func:`loop.train`, the JAX package's
``vaegan_tpu.train.loop.train``, while ``vaegan_tpu_torch.train.step`` and the
other submodules stay reachable as attributes."""

import sys
import types

from vaegan_tpu_torch.train.optim import build_optimizer
from vaegan_tpu_torch.train.state import (
    GeneratorState,
    TrainState,
    build_generator,
    build_models,
    create_generator_state,
    create_train_state,
    resolve_device,
)
from vaegan_tpu_torch.train.step import (
    fused_draws,
    lazy_gp_enabled,
    make_paper_train_step,
    make_step_variants,
    make_train_step,
    paper_draws,
)
from vaegan_tpu_torch.train.loop import TrainingDiverged, make_sampler, step_seed, train

__all__ = [
    "GeneratorState", "TrainState", "TrainingDiverged", "build_generator", "build_models",
    "build_optimizer", "create_generator_state", "create_train_state", "fused_draws",
    "lazy_gp_enabled", "make_paper_train_step", "make_sampler", "make_step_variants",
    "make_train_step", "paper_draws", "resolve_device", "step_seed", "train",
]


class _CallablePackage(types.ModuleType):
    def __call__(self, *args, **kwargs):
        return train(*args, **kwargs)


sys.modules[__name__].__class__ = _CallablePackage
