"""End-to-end example: train a VAE-GAN, evaluate reconstructions, sample the
prior, interpolate: the complete user journey of the reference notebook (the
port of ``examples/train_vaegan.py``).

Run with real data:   python -m vaegan_tpu_torch.examples.train_vaegan --data-dir nii
Run synthetically:    python -m vaegan_tpu_torch.examples.train_vaegan
On the CPU:           python -m vaegan_tpu_torch.examples.train_vaegan --device cpu

Writes ``reconstructions.png``, ``prior_samples.png`` and ``interpolation.png``
under ``--out`` and prints ``artifacts in OUT/ — recon MSE X``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from vaegan_tpu_torch import inference
from vaegan_tpu_torch.api import visualize_reconstructions
from vaegan_tpu_torch.config import Config, preset
from vaegan_tpu_torch.data.pipeline import make_loader
from vaegan_tpu_torch.train.loop import train
from vaegan_tpu_torch.train.state import resolve_device
from vaegan_tpu_torch.utils.imaging import save_image_grid


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--data-dir", default=None)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--image-size", type=int, default=96)
    ap.add_argument("--batch-size", type=int, default=64)
    ap.add_argument("--out", default="vaegan_out")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the CPU)")
    return ap


def build_config(args) -> Config:
    cfg = preset("notebook")  # the reference's exact VAE-GAN configuration
    return cfg.replace(
        data=cfg.data.replace(
            image_size=args.image_size, batch_size=args.batch_size,
            root_dir=args.data_dir or "nii", synthetic=args.data_dir is None),
        train=cfg.train.replace(
            n_epochs=args.epochs, dtype="bfloat16",
            checkpoint_dir=f"{args.out}/ckpt", sample_dir=f"{args.out}/samples"),
    )


def main(argv=None) -> float:
    args = build_parser().parse_args(argv)
    cfg = build_config(args)
    dev = resolve_device(args.device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    state, logger = train(cfg, device=dev)

    loader = make_loader(cfg.data, seed=0, device=dev)
    mse = visualize_reconstructions(cfg, state, loader, num_images=4,
                                    out_path=str(out / "reconstructions.png"))

    samples = inference.sample(cfg, state, torch.Generator(device=dev).manual_seed(0), n=25)
    save_image_grid(samples, str(out / "prior_samples.png"))

    batch = next(iter(loader))
    seq = inference.interpolate(cfg, state, batch[:1], batch[1:2], steps=8)
    save_image_grid(seq[:, 0], str(out / "interpolation.png"), nrow=8)
    print(f"artifacts in {out}/ — recon MSE {mse:.4f}", flush=True)
    return mse


if __name__ == "__main__":
    main()
