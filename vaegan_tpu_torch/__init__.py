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
blocks in the backward (``cfg.train.remat``); the JAX package's Orbax
checkpoints, read with neither JAX nor Orbax (``orbax_reader``, through
``CheckpointManager``), a live profiler capture endpoint
(``utils.profiling.start_server``) and the phase-decomposed transposed
convolution (``ops.conv``, off by default). Every TPU kernel of the
JAX package is a hand-written CUDA kernel here (``ops.fused``: ``bn_act_dropout``
forward and backward, ``reparam_kl`` forward and backward, ``recon_loss_sums``).
Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``. The
package imports torch, never jax. Its names are imported when first used, so
a module that needs little (``serving.load_bundle``: torch and ``ops.fused``)
loads no more than that.
"""

import importlib

# public name -> the module that defines it
_NAMES = {
    "Config": "config", "preset": "config",
    "evaluate_mse": "inference", "interpolate": "inference", "latent_shape": "inference",
    "mean_predictor_floor": "inference", "recalibrate_bn_stats": "inference",
    "reconstruct": "inference", "sample": "inference", "save_visual_evidence": "inference",
    "with_ema": "inference",
    "from_jax_variables": "interop", "load_jax_train_state": "interop",
    "Discriminator": "models", "UnsupervisedGeneratorNetwork": "models",
    "ServingBundle": "serving", "load_bundle": "serving", "save_bundle": "serving",
    "GeneratorState": "train", "TrainState": "train", "TrainingDiverged": "train",
    "build_generator": "train", "build_models": "train", "create_generator_state": "train",
    "create_train_state": "train", "make_paper_train_step": "train", "make_train_step": "train",
    "CheckpointManager": "checkpoint",
    "experiment": "api", "visualize_reconstructions": "api",
}
_MODULES = ("api", "bench", "checkpoint", "cli", "config", "data", "entry", "inference",
            "interop", "losses", "models", "ops", "orbax_reader", "parallel", "search",
            "serving", "train", "utils")

__all__ = sorted(set(_NAMES) | {"data", "parallel", "train", "utils"})


def __getattr__(name: str):
    if name in _MODULES:
        return importlib.import_module(f"{__name__}.{name}")
    if name not in _NAMES:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_NAMES[name]}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_NAMES) | set(_MODULES))
