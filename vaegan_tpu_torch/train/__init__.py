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
    make_step_variants,
    make_train_step,
)

__all__ = [
    "GeneratorState", "TrainState", "build_generator", "build_models", "build_optimizer",
    "create_generator_state", "create_train_state", "fused_draws", "lazy_gp_enabled",
    "make_step_variants", "make_train_step", "resolve_device",
]
