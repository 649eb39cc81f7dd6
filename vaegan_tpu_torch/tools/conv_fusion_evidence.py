"""Byte audit of one residual block (the port of
``tools/conv_fusion_evidence.py``).

One pre-activation ``ResBlockVAE`` downsample block (train mode, p = 0.5) of
the generator, forward only, at the JAX script's defaults. The JAX script
parses XLA's fusion groups; eager PyTorch has none, so the decisive number is
kept: the bytes the block's forward moves, counted by
``utils.cost_analysis.step_cost`` (every ATen op's own traffic; the fused
kernel, row 1, counted by its formula through ``fused.counting``), with
``use_pallas`` "off" (BN, LeakyReLU and dropout as separate passes) and "all"
(each BN + LeakyReLU + dropout chain one kernel), against the fully fused
ideal:

- aggressive: each convolution reads its input once and writes its output
  once, BN statistics ride the producing convolution, dropout masks are made
  in registers;
- conservative: plus one re-read per train-mode BN statistics pass.

The formulas are the JAX script's. Beside the bytes: each mode's time (CUDA
events over the forward; not measured on the CPU) and the op list with each
op's bytes, so the passes that go to memory and back are named.

    python -m vaegan_tpu_torch.tools.conv_fusion_evidence            # notebook-scale block
    python -m vaegan_tpu_torch.tools.conv_fusion_evidence --hlo ops.txt

Prints the JAX script's summary lines and one JSON line. ``--hlo`` writes the
op list of both modes (there is no HLO to dump). The flags are the JAX
script's, with its defaults, plus ``--device``.
"""

from __future__ import annotations

import argparse
import json
from collections import Counter
from pathlib import Path

import torch

from vaegan_tpu_torch.models import ResBlockVAE
from vaegan_tpu_torch.models.layers import precision
from vaegan_tpu_torch.tools.common import add_device, cuda_ms, parser, show_defaults
from vaegan_tpu_torch.train.state import DTYPES, resolve_device
from vaegan_tpu_torch.utils.cost_analysis import step_cost

MODES = ("off", "all")


def build_parser() -> argparse.ArgumentParser:
    ap = parser(__doc__)
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--image-size", type=int, default=96)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--hlo", help="write the op list of both modes (each op's name "
                                  "and bytes, in order) here")
    add_device(ap)
    return show_defaults(ap)


def ideal_bytes(batch: int, image_size: int, channels: int, bpe: int):
    """(aggressive, conservative) fully fused bytes of the block's forward
    (the JAX script's formulas): conv1 and the shortcut conv are 3x3 stride 2
    (cin -> c), conv2 3x3 stride 1; every conv output is at half resolution."""
    def nbytes(shape, itemsize=None):
        n = 1
        for s in shape:
            n *= s
        return n * (itemsize or bpe)

    b, hw, c = batch, image_size, channels
    cin = c // 2
    x_b = nbytes((b, hw, hw, cin))                  # block input
    o_b = nbytes((b, hw // 2, hw // 2, c))          # every conv output
    w_b = (9 * cin * c + 9 * c * c + 9 * cin * c) * bpe
    # reads: conv1(x), shortcut(x), conv2(h), the residual add (shortcut out);
    # writes: h, shortcut out, block out
    ideal_aggr = 2 * x_b + 5 * o_b + w_b
    # one extra read per train-mode BN (bn1 over x, bn2 over h, the shortcut's BN)
    ideal_cons = ideal_aggr + x_b + 2 * o_b
    return ideal_aggr, ideal_cons


def block_forward(args, mode: str, dev: torch.device):
    """``fn(i)``: the block's train-mode forward with ``use_pallas`` = mode
    (weights from seed 0, the same in both modes) on a fixed input."""
    dt = DTYPES[args.dtype]
    blk = ResBlockVAE(args.channels // 2, args.channels, mode="downsample", dropout_prob=0.5,
                      dtype=dt, use_pallas=mode == "all",
                      generator=torch.Generator().manual_seed(0)).to(dev)
    x = torch.rand((args.batch, args.channels // 2, args.image_size, args.image_size),
                   generator=torch.Generator().manual_seed(1)).to(dev, dt)
    x = x.contiguous(memory_format=torch.channels_last)

    @torch.no_grad()
    def fn(i: int) -> torch.Tensor:
        with precision(dt):
            return blk(x, train=True, generator=torch.Generator(device=dev).manual_seed(i),
                       seeds=torch.Generator().manual_seed(i))
    return fn


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    bpe = torch.tensor([], dtype=DTYPES[args.dtype]).element_size()
    ideal_aggr, ideal_cons = ideal_bytes(args.batch, args.image_size, args.channels, bpe)
    device = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"backend: {dev.type} ({device})")
    modes, listing = {}, []
    for mode in MODES:
        fn = block_forward(args, mode, dev)
        cost = step_cost(fn, 0)
        measured = cost["bytes accessed"]
        ops = Counter(name for name, _ in cost["ops"])
        by_op = Counter()
        for name, nbytes in cost["ops"]:
            by_op[name] += nbytes
        modes[mode] = {
            "measured_bytes_MB": round(measured / 1e6, 1),
            "ratio_vs_aggressive": round(measured / ideal_aggr, 2),
            "ratio_vs_conservative": round(measured / ideal_cons, 2),
            "ops": len(cost["ops"]),
            "kernel_calls": {k: v["calls"] for k, v in cost["kernels"].items()},
            "bytes_MB_by_op": {k: round(v / 1e6, 1) for k, v in by_op.most_common()},
            "ms": round(cuda_ms(fn), 4) if dev.type == "cuda" else None,
        }
        print(f"\nuse_pallas={mode}: {len(cost['ops'])} ops moving bytes; op counts "
              f"{dict(sorted(ops.items()))}")
        print(f"bytes accessed (counted, step_cost): {measured / 1e6:.1f} MB")
        print(f"ratio measured/ideal: {measured / ideal_cons:.2f}x .. "
              f"{measured / ideal_aggr:.2f}x")
        listing += [f"# use_pallas={mode}"] + [f"{name}\t{nbytes}" for name, nbytes in cost["ops"]]
    print(f"\nfully-fused ideal: {ideal_aggr / 1e6:.1f} MB (BN stats ride conv "
          f"epilogues) .. {ideal_cons / 1e6:.1f} MB (each BN stats pass re-reads)")
    if args.hlo:
        Path(args.hlo).write_text("\n".join(listing) + "\n")
    record = {
        "device": device,
        "operating_point": f"ResBlockVAE downsample {args.channels // 2}->{args.channels}, "
                           f"{args.image_size}^2 batch {args.batch} {args.dtype}, train, p=0.5",
        "ideal_fused_MB_aggressive": round(ideal_aggr / 1e6, 1),
        "ideal_fused_MB_conservative": round(ideal_cons / 1e6, 1),
        "modes": modes,
    }
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
