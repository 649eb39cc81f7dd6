"""Image-grid output (port of ``vaegan_tpu/utils/imaging.py``), matching
``torchvision.utils.save_image(..., nrow=5, normalize=True)`` as the reference
dumps it every ``sample_interval`` batches: min-max normalize over the WHOLE
batch, tile row-major with 2px padding, write a PNG."""

from __future__ import annotations

import numpy as np
import torch


def make_grid(images, nrow: int = 5, padding: int = 2,
              normalize: bool = True) -> np.ndarray:
    """images: (N, H, W, C) float -> (GH, GW, C) uint8 grid."""
    if isinstance(images, torch.Tensor):
        images = images.detach().float().cpu().numpy()
    imgs = np.asarray(images, np.float32)
    if normalize:
        lo, hi = imgs.min(), imgs.max()
        imgs = (imgs - lo) / max(hi - lo, 1e-12)
    imgs = np.clip(imgs, 0.0, 1.0)
    n, h, w, c = imgs.shape
    ncol = min(nrow, n)
    nrows = int(np.ceil(n / ncol))
    grid = np.zeros((nrows * (h + padding) + padding,
                     ncol * (w + padding) + padding, c), np.float32)
    for idx in range(n):
        r, col = divmod(idx, ncol)
        y = r * (h + padding) + padding
        x = col * (w + padding) + padding
        grid[y:y + h, x:x + w] = imgs[idx]
    return (grid * 255.0 + 0.5).astype(np.uint8)


def save_image_grid(images, path: str, nrow: int = 5, normalize: bool = True) -> None:
    """(N, H, W, C) tensor (any device) or numpy array -> PNG at ``path``."""
    from PIL import Image

    grid = make_grid(images, nrow=nrow, normalize=normalize)
    if grid.shape[-1] == 1:
        Image.fromarray(grid[..., 0], mode="L").save(path)
    else:
        Image.fromarray(grid).save(path)
