"""High-level API mirroring the reference's entry points (port of ``vaegan_tpu/api.py``).

``experiment(...)`` takes the reference's ``experiment()`` surface (network
depth / length / feature size, the discriminator's parameter dict, loss weights,
lr, n_critics, ...), maps it onto the Config tree, trains, and returns the final
train state and the Config. ``visualize_reconstructions(...)`` runs one loader
batch through the eval-mode generator, writes an original-vs-reconstruction grid
and prints the MSE.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

from vaegan_tpu_torch import inference
from vaegan_tpu_torch.config import Config, DiscriminatorConfig, GeneratorConfig
from vaegan_tpu_torch.train.loop import train
from vaegan_tpu_torch.train.state import TrainState


def experiment(
    *,
    network_depth: Optional[int] = None,      # default 2
    network_length: Optional[int] = None,     # default 1
    feature_size: Optional[int] = None,       # default 64
    discriminator_params: Optional[Dict[str, Any]] = None,
    is_vae: Optional[bool] = None,            # default True
    lr: Optional[float] = None,               # default 3e-4
    n_epochs: Optional[int] = None,           # default 3
    adversarial_loss_weight: Optional[float] = None,   # default 1.0
    reconstruction_loss_weight: Optional[float] = None,  # default 10.0
    kl_weight: Optional[float] = None,        # default 0.1
    n_critics: Optional[int] = None,          # default 1
    image_size: Optional[int] = None,         # default 96
    batch_size: Optional[int] = None,         # default 4
    root_dir: Optional[str] = None,           # default "nii"
    synthetic_data: Optional[bool] = None,    # default False
    seed: Optional[int] = None,               # default 0
    config_overrides: Optional[Config] = None,
    loader=None,
    neptune_run=None,
    device="cuda",
) -> Tuple[TrainState, Config]:
    """Train a VAE-GAN with the reference's experiment surface; returns
    ``(state, config)``. ``adversarial_loss_weight=0`` is the plain-VAE run.

    ``neptune_run``: the reference's ``use_neptune`` knob; pass a
    ``neptune.init_run``-style object and the 7 reference channels stream to it
    (:class:`~vaegan_tpu_torch.utils.metrics.NeptuneSink`); ``run.stop()`` is
    called at the end. ``device``: ``"cuda"`` unless the caller asks for
    ``"cpu"``."""
    kwargs = dict(
        network_depth=network_depth, network_length=network_length,
        feature_size=feature_size, discriminator_params=discriminator_params,
        is_vae=is_vae, lr=lr, n_epochs=n_epochs,
        adversarial_loss_weight=adversarial_loss_weight,
        reconstruction_loss_weight=reconstruction_loss_weight,
        kl_weight=kl_weight, n_critics=n_critics, image_size=image_size,
        batch_size=batch_size, root_dir=root_dir,
        synthetic_data=synthetic_data, seed=seed)
    if config_overrides is not None:
        passed = [k for k, v in kwargs.items() if v is not None]
        if passed:
            # config_overrides is a COMPLETE config, not a base to merge into:
            # dropping explicit kwargs silently would train with hyperparameters
            # the caller did not ask for
            raise ValueError(
                f"config_overrides replaces the whole config; also passing "
                f"{passed} is ambiguous — set those fields on the Config "
                f"(cfg.replace(...)) instead")
        cfg = config_overrides
    else:
        defaults = dict(
            network_depth=2, network_length=1, feature_size=64, is_vae=True,
            lr=3e-4, n_epochs=3, adversarial_loss_weight=1.0,
            reconstruction_loss_weight=10.0, kl_weight=0.1, n_critics=1,
            image_size=96, batch_size=4, root_dir="nii",
            synthetic_data=False, seed=0)
        v = {k: (defaults[k] if kwargs.get(k) is None else kwargs[k])
             for k in defaults}
        d = discriminator_params or dict(
            num_stride_conv1=1, num_features_conv1=64, num_blocks=(1, 1, 1),
            num_strides_res=(1, 2, 2), num_features_res=(128, 256, 512))
        base = Config()
        cfg = base.replace(
            generator=GeneratorConfig(
                depth=v["network_depth"], length=v["network_length"],
                feature_size=v["feature_size"], is_vae=v["is_vae"]),
            discriminator=DiscriminatorConfig(
                **{k: tuple(x) if isinstance(x, (list, tuple)) else x
                   for k, x in d.items()}),
            loss=base.loss.replace(
                adversarial_weight=v["adversarial_loss_weight"],
                reconstruction_weight=v["reconstruction_loss_weight"],
                kl_weight=v["kl_weight"]),
            optim=base.optim.replace(lr=v["lr"]),
            data=base.data.replace(
                image_size=v["image_size"], batch_size=v["batch_size"],
                root_dir=v["root_dir"], synthetic=v["synthetic_data"]),
            train=base.train.replace(n_epochs=v["n_epochs"],
                                     n_critics=v["n_critics"], seed=v["seed"]),
        )
    logger = None
    if neptune_run is not None:
        from vaegan_tpu_torch.utils.metrics import MetricsLogger, NeptuneSink, StdoutSink

        logger = MetricsLogger(sinks=[StdoutSink(), NeptuneSink(neptune_run)],
                               flush_every=cfg.train.log_every)
    state, logger = train(cfg, loader=loader, logger=logger, device=device)
    if neptune_run is not None:
        logger.close()  # flush, then run.stop()
    return state, cfg


def visualize_reconstructions(
    cfg: Config,
    state: TrainState,
    loader,
    num_images: int = 5,
    out_path: Optional[str] = None,
) -> float:
    """Eval-mode reconstruction of one loader batch on the state's device;
    writes an original/reconstruction grid PNG and returns the MSE."""
    batch = next(iter(loader))
    recon, mse = inference.reconstruct(cfg, state, batch)
    n = min(num_images, recon.shape[0])
    if out_path is not None:
        import torch

        from vaegan_tpu_torch.utils.imaging import save_image_grid
        orig = inference._as_input(batch, recon.device)
        save_image_grid(torch.cat([orig[:n], recon[:n].float()]), out_path, nrow=n)
    mse_f = float(mse)
    print(f"Mean squared error between original and reconstructed images: {mse_f:.4f}")
    return mse_f
