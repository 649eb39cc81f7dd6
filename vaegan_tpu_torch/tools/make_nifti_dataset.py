"""Generate a reference-sized NIfTI dataset on disk for end-to-end data-path
runs (the port of ``tools/make_nifti_dataset.py``).

The reference trains from ~1,200 hand-X-ray NIfTI files that it downloads.
This tool writes the same volume of data in the same container format: N
single-file NIfTI-1 images rendered from the synthetic styles at a source
resolution drawn per image (like real scans), with arbitrary intensity ranges
(the loader's min-max normalisation has work to do) and a mix of ``.nii`` and
``.nii.gz`` (every third file, so the native decoder's zlib path runs too).
The same arguments write the JAX script's files: the same numpy draws, the
same resize and the same writer.

    python -m vaegan_tpu_torch.tools.make_nifti_dataset --out nii_blobs --n 1200
    python -m vaegan_tpu_torch.examples.reproduce_headline --vae --data-dir nii_blobs

The flags are the JAX script's with its defaults, plus ``--device``, which
every tool takes: this one renders on the host and only checks that the
device is there.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

from vaegan_tpu_torch.data.nifti import resize_bilinear, write_nifti
from vaegan_tpu_torch.data.pipeline import SyntheticDataset
from vaegan_tpu_torch.tools.common import add_device, parser, show_defaults
from vaegan_tpu_torch.train.state import resolve_device


def build_parser() -> argparse.ArgumentParser:
    ap = parser(__doc__)
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--n", type=int, default=1200,
                    help="number of images (the reference's dataset is ~1200)")
    ap.add_argument("--style", default="blobs",
                    choices=["blobs", "edges", "texture"],
                    help="synthetic style (matches SyntheticDataset's; "
                         "'texture' renders the fine field at source_size//4 "
                         "like SyntheticDataset does at image_size//4)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--min-size", type=int, default=280)
    ap.add_argument("--max-size", type=int, default=420,
                    help="per-image source resolution drawn uniformly from "
                         "[min,max] per axis (real scans vary; the resize path "
                         "must actually run)")
    add_device(ap)
    return show_defaults(ap)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    resolve_device(args.device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    # the low-frequency process of SyntheticDataset (12x12 normal fields,
    # bilinearly upsampled), rendered at each file's own size
    base = rng.normal(size=(args.n, 12, 12)).astype(np.float32)
    sizes = rng.integers(args.min_size, args.max_size + 1, size=(args.n, 2))
    # arbitrary intensity ranges per file, like real scanner output
    scales = rng.uniform(500.0, 4000.0, size=args.n).astype(np.float32)
    offsets = rng.uniform(-200.0, 800.0, size=args.n).astype(np.float32)

    t0 = time.time()
    total_bytes = 0
    for i in range(args.n):
        h, w = int(sizes[i, 0]), int(sizes[i, 1])
        img = resize_bilinear(base[i], h, w)
        if args.style == "edges":
            img = SyntheticDataset._quantize(img)
        elif args.style == "texture":
            fine = rng.normal(size=(max(h // 4, 3), max(w // 4, 3))).astype(np.float32)
            quantize = SyntheticDataset._quantize
            img = 0.6 * quantize(img) + 0.4 * quantize(resize_bilinear(fine, h, w))
        else:
            lo, hi = img.min(), img.max()
            img = (img - lo) / max(hi - lo, 1e-12)
        img = img * scales[i] + offsets[i]
        name = f"img_{i:04d}.nii" + (".gz" if i % 3 == 0 else "")
        write_nifti(out / name, img.astype(np.float32))
        total_bytes += (out / name).stat().st_size
    record = {
        "out": str(out), "n": args.n, "style": args.style,
        "size_range": [args.min_size, args.max_size],
        "disk_mb": round(total_bytes / 1e6, 1),
        "wall_s": round(time.time() - t0, 1),
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
