from vaegan_tpu_torch.train.state import (
    GeneratorState,
    build_models,
    create_generator_state,
    resolve_device,
)

__all__ = ["GeneratorState", "build_models", "create_generator_state", "resolve_device"]
