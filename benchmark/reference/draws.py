"""The random draws of the system under test, worked out again from the seeds.

Frozen copies of what the program derives from the seeds the benchmark hands
it, so that the reference can follow the same step without reading any of the
program's state:

- a step's int seed: splitmix64's finalizer over ``seed * 2**32 + step`` plus
  the golden gamma (both words taken modulo 2**32);
- the loader's epoch order: ``numpy.random.default_rng(seed)``, one
  ``shuffle`` of ``arange(n)`` per epoch, batches cut in that order;
- the seed of each fused dropout site and of the reparameterisation noise: one
  ``torch.randint(0, 2**63 - 1, ())`` each from a CPU generator seeded with the
  step seed, in forward order;
- the dropout keep bits and the reparameterisation noise: Philox4x32-10 keyed
  on the site's seed, counter (flat NHWC index // 4, 0) for dropout (word
  index % 4, kept when ``float(bits >> 8) >= p * 2**24``) and (index // 2, 1)
  for the noise (Box-Muller over words (0, 1) or (2, 3)).
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np
import torch

_M64 = (1 << 64) - 1
_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B97F4A7C15
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _splitmix64(x: int) -> int:
    x &= _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def step_seed(seed: int, step: int) -> int:
    """The int seed the training loop gives global step ``step`` of a run
    seeded ``seed``."""
    return _splitmix64((((seed & _M32) << 32) | (step & _M32)) + _GOLDEN)


def epoch_batches(n: int, batch: int, seed: int, drop_last: bool = False) -> Iterator[np.ndarray]:
    """The index arrays of every batch, epoch after epoch, that a shuffling
    loader seeded ``seed`` gives over ``n`` items."""
    rng = np.random.default_rng(seed)
    stop = n - batch + 1 if drop_last else n
    while True:
        idx = np.arange(n)
        rng.shuffle(idx)
        for s in range(0, stop, batch):
            yield idx[s:s + batch]


def site_seeds(step_seed_: int, count: int) -> List[int]:
    """The first ``count`` kernel seeds drawn from a CPU generator seeded
    ``step_seed_``."""
    g = torch.Generator().manual_seed(step_seed_)
    return [int(torch.randint(0, 2 ** 63 - 1, (), generator=g)) for _ in range(count)]


def _mulhilo(m: int, b: torch.Tensor):
    lo16 = m * (b & 0xFFFF)
    hi16 = m * (b >> 16)
    mid = hi16 + (lo16 >> 16)
    return mid >> 16, ((mid & 0xFFFF) << 16) | (lo16 & 0xFFFF)


def philox(counter: torch.Tensor, stream: int, seed: int):
    """The four 32-bit words (int64 tensors) of Philox4x32-10 at counters
    (``counter``, ``stream``, 0) under key (seed lo, seed hi)."""
    c0, c1 = counter & _M32, counter >> 32
    c2 = torch.full_like(counter, stream)
    c3 = torch.zeros_like(counter)
    k0, k1 = seed & _M32, (seed >> 32) & _M32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_mask_nchw(shape, seed: int, p: float, device) -> torch.Tensor:
    """The keep mask (bool, (N, C, H, W)) of a fused dropout site of that shape,
    each element drawn at its flat NHWC index."""
    n, c, h, w = shape
    numel = n * c * h * w
    words = philox(torch.arange((numel + 3) // 4, dtype=torch.int64, device=device), 0, seed)
    bits = torch.stack(words, dim=1).reshape(-1)[:numel]
    keep = (bits >> 8).to(torch.float32) >= float(np.float32(p * (1 << 24)))
    return keep.view(n, h, w, c).permute(0, 3, 1, 2)


def noise_nchw(shape, seed: int, device) -> torch.Tensor:
    """The reparameterisation noise (float32, (N, C, H, W)) of a latent of that
    shape, each element drawn at its flat NHWC index."""
    n, c, h, w = shape
    numel = n * c * h * w
    w0, w1, w2, w3 = philox(torch.arange((numel + 1) // 2, dtype=torch.int64, device=device),
                            1, seed)
    b1 = torch.stack((w0, w2), dim=1).reshape(-1)[:numel]
    b2 = torch.stack((w1, w3), dim=1).reshape(-1)[:numel]
    u1 = ((b1 >> 8).to(torch.float32) + 1.0) * 2.0 ** -24
    u2 = (b2 >> 8).to(torch.float32) * 2.0 ** -24
    eps = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(float(np.float32(2 * np.pi)) * u2)
    return eps.view(n, h, w, c).permute(0, 3, 1, 2)
