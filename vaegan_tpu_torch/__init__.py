"""vaegan_tpu_torch: the PyTorch/CUDA port of ``vaegan_tpu``, for NVIDIA Hopper.

Ported so far: the serving path (the eval-mode generator behind reconstruct /
encode / decode / sample / interpolate and the serving bundle) and the notebook's
two-optimizer WGAN-GP train step (``create_train_state``, ``make_train_step``:
generator, spectral-norm critic, losses, RMSprop). Every TPU kernel of the JAX
package is a hand-written CUDA kernel here (``ops.fused``: ``bn_act_dropout``
forward and backward, ``reparam_kl`` forward and backward, ``recon_loss_sums``).
Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``. The
package imports torch, never jax.
"""

from vaegan_tpu_torch.config import Config, preset
from vaegan_tpu_torch.inference import (
    evaluate_mse,
    interpolate,
    latent_shape,
    mean_predictor_floor,
    recalibrate_bn_stats,
    reconstruct,
    sample,
    with_ema,
)
from vaegan_tpu_torch.interop import from_jax_variables, load_jax_train_state
from vaegan_tpu_torch.models import Discriminator, UnsupervisedGeneratorNetwork
from vaegan_tpu_torch.serving import ServingBundle, load_bundle, save_bundle
from vaegan_tpu_torch.train import (
    GeneratorState,
    TrainState,
    build_generator,
    build_models,
    create_generator_state,
    create_train_state,
    make_train_step,
)

__all__ = [
    "Config", "Discriminator", "GeneratorState", "ServingBundle", "TrainState",
    "UnsupervisedGeneratorNetwork", "build_generator", "build_models",
    "create_generator_state", "create_train_state", "evaluate_mse", "from_jax_variables",
    "interpolate", "latent_shape", "load_bundle", "load_jax_train_state",
    "make_train_step", "mean_predictor_floor", "preset", "recalibrate_bn_stats",
    "reconstruct", "sample", "save_bundle", "with_ema",
]
