"""vaegan_tpu_torch: the PyTorch/CUDA port of ``vaegan_tpu``, for NVIDIA Hopper.

This slice is the serving path: the eval-mode generator (encoder -> spatial VAE
code processor -> decoder) behind reconstruct / encode / decode / sample /
interpolate and the serving bundle, with the res-block BN + LeakyReLU + dropout
chain as a hand-written CUDA kernel (``ops.fused.bn_act_dropout``). Entry points
run on ``"cuda"`` unless the caller passes ``device="cpu"``. The package imports
torch, never jax.
"""

from vaegan_tpu_torch.config import Config, preset
from vaegan_tpu_torch.inference import (
    evaluate_mse,
    interpolate,
    latent_shape,
    mean_predictor_floor,
    reconstruct,
    sample,
    with_ema,
)
from vaegan_tpu_torch.interop import from_jax_variables
from vaegan_tpu_torch.models import UnsupervisedGeneratorNetwork
from vaegan_tpu_torch.serving import ServingBundle, load_bundle, save_bundle
from vaegan_tpu_torch.train.state import (
    GeneratorState,
    build_models,
    create_generator_state,
)

__all__ = [
    "Config", "GeneratorState", "ServingBundle", "UnsupervisedGeneratorNetwork",
    "build_models", "create_generator_state", "evaluate_mse", "from_jax_variables",
    "interpolate", "latent_shape", "load_bundle", "mean_predictor_floor", "preset",
    "reconstruct", "sample", "save_bundle", "with_ema",
]
