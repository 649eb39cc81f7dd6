"""vaegan_tpu_torch: the PyTorch/CUDA port of ``vaegan_tpu``, for NVIDIA Hopper.

Ported so far: the serving path (the eval-mode generator behind reconstruct /
encode / decode / sample / interpolate and the serving bundle), the notebook's
two-optimizer WGAN-GP train step (``create_train_state``, ``make_train_step``:
generator, spectral-norm critic, losses, RMSprop), the Larsen three-optimizer
step (``make_paper_train_step``), gradient accumulation and the ``concat`` /
``concat3`` critic batchings for both (``cfg.train.grad_accum``,
``cfg.train.critic_batching``), and the training loop around
it: the data feed (``data``: NIfTI decode, synthetic data, the host loader, a
dataset resident on the card, pinned-buffer prefetch), ``train`` (callable:
``vaegan_tpu_torch.train(cfg)``), checkpoints (``CheckpointManager``), metric
sinks and sample grids (``utils``) and ``experiment``; and the single-card
surface: the CLI (``python -m vaegan_tpu_torch.cli``), ``search``, ``entry``
and the bench (``python -m vaegan_tpu_torch.bench``); data-parallel training
over ``torch.distributed`` processes, one per device (``parallel``:
``make_mesh``, ``make_parallel_train_step``, ``parallel.train.train_data_parallel``;
``cli train --dp`` under ``torchrun``) and recomputation of the residual
blocks in the backward (``cfg.train.remat``). Every TPU kernel of the
JAX package is a hand-written CUDA kernel here (``ops.fused``: ``bn_act_dropout``
forward and backward, ``reparam_kl`` forward and backward, ``recon_loss_sums``).
Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``. The
package imports torch, never jax.
"""

from vaegan_tpu_torch import data, utils
from vaegan_tpu_torch.config import Config, preset
from vaegan_tpu_torch.inference import (
    evaluate_mse,
    interpolate,
    latent_shape,
    mean_predictor_floor,
    recalibrate_bn_stats,
    reconstruct,
    sample,
    save_visual_evidence,
    with_ema,
)
from vaegan_tpu_torch.interop import from_jax_variables, load_jax_train_state
from vaegan_tpu_torch.models import Discriminator, UnsupervisedGeneratorNetwork
from vaegan_tpu_torch.serving import ServingBundle, load_bundle, save_bundle
from vaegan_tpu_torch import train
from vaegan_tpu_torch import parallel
from vaegan_tpu_torch.train import (
    GeneratorState,
    TrainState,
    TrainingDiverged,
    build_generator,
    build_models,
    create_generator_state,
    create_train_state,
    make_paper_train_step,
    make_train_step,
)
from vaegan_tpu_torch.checkpoint import CheckpointManager
from vaegan_tpu_torch.api import experiment, visualize_reconstructions

__all__ = [
    "CheckpointManager", "Config", "Discriminator", "GeneratorState", "ServingBundle",
    "TrainState", "TrainingDiverged", "UnsupervisedGeneratorNetwork", "build_generator",
    "build_models", "create_generator_state", "create_train_state", "data", "evaluate_mse",
    "experiment", "from_jax_variables", "interpolate", "latent_shape", "load_bundle",
    "load_jax_train_state", "make_paper_train_step", "make_train_step", "mean_predictor_floor",
    "parallel", "preset",
    "recalibrate_bn_stats", "reconstruct", "sample", "save_bundle", "save_visual_evidence",
    "train", "utils", "visualize_reconstructions", "with_ema",
]
