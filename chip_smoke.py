#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``vaegan_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. environment: the card, its power limit, torch/CUDA versions; builds every CUDA
   kernel from ``vaegan_tpu_torch/csrc`` (one ``nvcc`` per source, started
   together) and prints registers and spills per kernel; counts each kernel's
   hot-loop instructions per element in its SASS (``cuobjdump -sass``; the
   fewest that a vector pass can run), the instruction side of every bound (over
   SMs x 128 lanes x the maximum SM clock; the byte side is the data-sheet memory
   rate), and fails if any kernel
   holds a float atomic. TF32 is switched off for
   convolutions and matmuls for the parity phases; the port's float32 layers and
   train step pin IEEE float32 themselves, so phases 3 and 6 repeat their
   comparisons with PyTorch's default flags restored, and phases 4 and 7 time the
   default path users get;
2. serving kernel against its plain PyTorch version: ``bn_act_dropout`` at each
   of the served model's fused-BN sites at batch 64, float32 and bfloat16,
   dropout p = 0 and 0.5, bitwise equal, timed with CUDA events beside its bound;
3. the served model: ``preset("vaegan_infer")`` (the notebook generator, 256²,
   float32, full width) with ``use_pallas="all"`` and seeded random weights
   answers reconstruct / encode / decode / sample / interpolate requests through
   the port's entry points and a serving bundle; the launch counts show every
   fused BN went through the kernel; the outputs are held against the
   ``use_pallas="off"`` model on the card and the CPU model on a small batch;
4. serving numbers: reconstruct images/s at batch 64, batch-1 latency, sample
   images/s;
5. training kernels against their plain versions at the notebook step's shapes
   (batch 4), float32 and bfloat16: ``bn_act_dropout`` forward and backward at
   the 12 sites (each at the p the step runs it with), ``reparam_kl`` forward and
   backward, ``recon_loss_sums`` (also at batch 16); y, dx and z bitwise the plain
   versions', the dropout mask and the reparameterization noise replayed bit for
   bit by the backwards; rows 2, 3 and 5 (one launch each, a grid reduction
   inside) run twenty times bitwise equal, one run beside a matrix product on a
   side stream and one on a second stream at once, and show one kernel and no
   other under torch.profiler (its device time printed beside the call's);
   kernel / plain / yardstick times beside each bound (bytes and instructions),
   and for row 5 the launch floor (an empty kernel on the same grid);
6. the training step: ``preset("notebook")`` (256², float32, full-width
   generator and 139.7 M-parameter critic, WGAN-GP, RMSprop, clamp) with
   ``use_pallas="all"`` takes six steps (four G+D, two critic-only) through
   ``create_train_state`` / ``make_train_step`` with exact kernel launch counts
   per step; then the fused step is held against the ``use_pallas="off"`` step
   with its own dropout masks and noise injected (TF32 forced off, and again
   with the default flags), against itself under both flag settings (the
   step's backward pins IEEE float32; a TF32 step is shown to miss that
   tolerance), and against the CPU at 64², batch 2;
7. training numbers: step ms and images/s at batch 4 and 16, the top device
   kernels of a profiled step, the device-busy share, each kernel's share.

The second-to-last line is a JSON object describing each kernel; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Data-sheet memory rate, bytes/s: the byte side of every bound.
CARD_BANDWIDTH = {
    "H100 PCIe": 2.0e12,
    "H100": 3.35e12,      # SXM5 80 GB
}
# thread-instructions an SM starts per clock (4 schedulers x 32 lanes): the
# instruction side of every bound is the hot loop's SASS count over SMs x this x clock
LANES_PER_SM = 128

SEED = 0
BATCH = 64
SLOPE = 0.01


def log(*a):
    print(*a, flush=True)


def card_bandwidth(name: str):
    for key, bw in CARD_BANDWIDTH.items():
        if key in name:
            return bw
    raise SystemExit(f"chip_smoke: no data-sheet memory rate for card {name!r}")


# ---------------------------------------------------------------------------
# instructions per element, counted in the compiled kernels (cuobjdump -sass)
# ---------------------------------------------------------------------------

SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;")
BRANCH = re.compile(r"^(@!?U?P[T0-9]+\s+)?BRA(?:\.[A-Z]+)*\s+(!?U?P[T0-9]+,\s*)?(0x[0-9a-f]+)")
WIDE_LOAD = re.compile(r"^(@\S+\s+)?LDG\.E\.(128|64)\b")
DEAD_END = re.compile(r"^(EXIT|RET)\b")
FLOAT_ATOMIC = re.compile(r"\b(RED|ATOM|ATOMG|ATOMS)\.\S*F(16x2|32|64)\b")
# each kernel's hot loop reads these arrays with one wide access per 4 elements
KERNEL_INPUTS = {"bn_act_dropout_fwd_kernel": 1, "bn_act_dropout_bwd_kernel": 2,
                 "reparam_fwd_kernel": 2, "reparam_bwd_kernel": 3, "recon_sums_kernel": 2}


def sass_functions(text):
    """{mangled name: [(address, instruction)]} from ``cuobjdump -sass`` output."""
    return {chunk.split("\n", 1)[0].strip():
            [(int(a, 16), ins) for a, ins in SASS_LINE.findall(chunk)]
            for chunk in re.split(r"\n\s*Function : ", text)[1:]}


def _branch(ins):
    """(target, conditional) of a BRA, else None."""
    m = BRANCH.match(ins)
    return (int(m.group(3), 16), bool(m.group(1) or m.group(2))) if m else None


def _backward(address, ins):
    b = _branch(ins)
    return b is not None and b[0] <= address


def hot_loop_instructions(code, inputs):
    """Instructions per element on the hot path of a kernel's grid-stride loop, as a
    lower bound. The loop is the backward branch whose body holds the most 16- or
    8-byte global loads. Of the paths from its head to that branch, the count takes
    the one with the most wide loads (the aligned vector path) and, of those, the
    fewest instructions: every forward branch that can skip work (a slow path such
    as cosf's Payne-Hanek reduction or sqrtf's special cases, a dropout branch
    decided at run time) counts as skipping it, so no branch that is not taken can
    raise the count. A branch out of the loop falls through; a nested loop's body
    counts at most once. Elements per pass: 4 per wide load on the path over the
    ``inputs`` arrays read."""
    index = {a: i for i, (a, _) in enumerate(code)}
    loops = []
    for i, (a, ins) in enumerate(code):
        if _backward(a, ins):
            b = _branch(ins)
            wide = sum(bool(WIDE_LOAD.match(x)) for _, x in code[index[b[0]]:i + 1])
            if wide:
                loops.append((-wide, i - index[b[0]], index[b[0]], i))
    if not loops:
        return None
    _, _, head, end = min(loops)
    # best[i]: (-wide loads, instructions) of the best path from i to the back branch
    best = {end: (-int(bool(WIDE_LOAD.match(code[end][1]))), 1)}
    for i in range(end - 1, head - 1, -1):
        a, ins = code[i]
        b = _branch(ins)
        if b is not None and a < b[0] <= code[end][0]:
            succ = [index[b[0]]] + ([i + 1] if b[1] else [])   # forward, inside the loop
        elif b is not None and b[1] or b is None and not DEAD_END.match(ins):
            succ = [i + 1]  # straight on; a conditional branch back or out falls through
        else:
            succ = []       # an unconditional jump back or out, an exit: no path on
        paths = [best[j] for j in succ if j in best]
        if paths:
            w, n = min(paths)
            best[i] = (w - bool(WIDE_LOAD.match(ins)), n + 1)
    if head not in best or best[head][0] == 0:
        return None
    wide, executed = best[head]
    return executed * inputs / (4 * -wide)


def kernel_counts(libs, cuobjdump):
    """From ``cuobjdump -sass`` of each built library: {(kernel, dtype, vec,
    dropout): instructions per element} of every kernel with a vectorised loop
    (vec and dropout None where the kernel has no such template argument), and the
    names of the kernels that hold a float atomic."""
    counts, atomics = {}, []
    for lib in libs.values():
        text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                              check=True, timeout=120).stdout
        for name, code in sass_functions(text).items():
            if any(FLOAT_ATOMIC.search(x) for _, x in code):
                atomics.append(name)
            for kernel, inputs in KERNEL_INPUTS.items():
                m = re.search(kernel + r"I(13__nv_bfloat16|f)(?:Li(\d)E)?(?:Lb(\d)E)?", name)
                if m:
                    break
            else:
                continue
            n = hot_loop_instructions(code, inputs)
            if n is not None:
                dtype = "bfloat16" if m.group(1).startswith("13") else "float32"
                counts[(kernel, dtype, int(m.group(2)) if m.group(2) else None,
                        bool(int(m.group(3))) if m.group(3) else None)] = n
    return counts, atomics


class Bounds:
    """The least time of a kernel's work on this card, the larger of two: the bytes
    it must move (each input read once, each output written once) over the
    data-sheet memory rate, and the instructions its hot loop runs per element
    (:func:`kernel_counts`) times the elements over the instruction rate, SMs x 128
    lanes x the SM's maximum clock."""

    def __init__(self, bw, instr_rate, counts):
        self.bw, self.instr_rate, self.counts = bw, instr_rate, counts

    def __call__(self, nbytes, n, kernel, dtype, vec=None, dropout=None):
        """(least ms, "bytes" or "operations", byte ms, instruction ms)."""
        tb = nbytes / self.bw
        ti = self.counts[(kernel, str(dtype)[6:], vec, dropout)] * n / self.instr_rate
        return max(tb, ti) * 1e3, "bytes" if tb >= ti else "operations", tb * 1e3, ti * 1e3


def time_cuda(torch, fn, reps=20, windows=5, warmup=3):
    """Device milliseconds per call of ``fn(i)``: CUDA events around ``reps``
    back-to-back calls, queued behind a sleep kernel so the host's launch cost
    stays off the clock; the median over ``windows`` such windows."""
    for i in range(warmup):
        fn(i)
    times = []
    for _ in range(windows):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(100_000_000)       # ~50 ms of the SM clock
        s.record()
        for i in range(reps):
            fn(i)
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / reps)
    return statistics.median(times)


def profile_split(torch, fn, calls=20):
    """{kernel name: (device ms per launch, launches recorded)} of every kernel that
    ``fn(i)`` launches, under torch.profiler over ``calls`` calls after one warm-up
    (the profiler may drop some of a run's device events, so a kernel's launches
    recorded can fall short of its launches)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            m = re.search(r"(\w+_kernel(<[^>]*>)?)", e.key)
            name = m.group(1) if m else e.key[:80]
            ms, count = out.get(name, (0.0, 0))
            out[name] = (ms + e.self_device_time_total / 1e3, count + e.count)
    return {name: (ms / count, count) for name, (ms, count) in out.items()}


def split_text(split, calls=20):
    return ", ".join(f"{name} {ms:.4f} ms a launch ({count} launches recorded in {calls} calls)"
                     for name, (ms, count) in split.items())


def one_kernel(what, split):
    """Fail if the profile of a kernel's calls shows a second kernel (no check where
    the profiler recorded no device time)."""
    if len(split) > 1:
        raise SystemExit(f"{what}: a call launches more than one kernel: {split_text(split)}")


def time_host(torch, fn, reps, warmup=2):
    """Median seconds of ``fn`` ending in a device synchronise."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def bf16_ulp(torch, r):
    """One bfloat16 unit in the last place of each value of ``r`` (float32)."""
    a = r.abs().clamp_min(torch.finfo(torch.bfloat16).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def fused_sites(torch, gen, size, channels):
    """(C, H, W) of every fused BN of a reconstruct, in launch order: bn1 sees the
    block input, bn2 the conv1 output (the block output's shape)."""
    from vaegan_tpu_torch.models import ResBlockVAE

    shapes = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: shapes.append((tuple(inp[0].shape[1:]), tuple(out.shape[1:]))))
        for m in gen.modules() if isinstance(m, ResBlockVAE)]
    with torch.inference_mode():
        gen(torch.zeros(1, size, size, channels, device="cuda"), train=False)
    for h in hooks:
        h.remove()
    return [s for pair in shapes for s in pair]


def phase_kernel(torch, sites, bounds):
    from vaegan_tpu_torch.ops import fused

    log("== phase 2: bn_act_dropout kernel vs its plain version "
        f"(batch {BATCH}; kernel: median of 5 CUDA-event windows of 20 back-to-back "
        "launches after 3 warm-up; plain: one window of 20 calls; y bitwise the plain "
        "version's) ==")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    summary = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "two_call_ms": 0.0,
               "bound_by": "bytes", "max_abs_err": 0.0, "bytes_ms": 0.0, "instr_ms": 0.0}
    # (dtype, p) -> [kernel ms, plain ms, bound ms, byte bound ms] summed over the sites
    sums = {}
    for i, (c, h, w) in enumerate(sites):
        mean = torch.randn(c, device="cuda", generator=g) * 0.3
        var = torch.rand(c, device="cuda", generator=g) * 1.5 + 0.5
        scale = torch.rand(c, device="cuda", generator=g) + 0.5
        bias = torch.randn(c, device="cuda", generator=g) * 0.1
        x32 = torch.randn(BATCH, c, h, w, device="cuda", generator=g).contiguous(
            memory_format=torch.channels_last)
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            for p in (0.0, 0.5):
                seed = 1234 + i
                args = (x, mean, var, scale, bias, seed, SLOPE, p)
                y = fused.bn_act_dropout(*args)
                r = fused.bn_act_dropout_reference(*args)
                torch.cuda.synchronize()
                if not (y.is_contiguous(memory_format=torch.channels_last) and y.dtype == dtype):
                    raise SystemExit(f"site {i}: kernel output has the wrong layout or dtype")
                yf, rf = y.float(), r.float()
                err = (yf - rf).abs()
                bitwise = torch.equal(y, r)
                masks_equal = True
                if p > 0:
                    keep = fused.keep_mask(x, seed, p)
                    masks_equal = int(((yf != 0) & ~keep).sum()) == 0
                    kept = float(keep.float().mean())
                    if not 0.45 <= kept <= 0.55:
                        raise SystemExit(f"site {i}: keep rate {kept} outside [0.45, 0.55]")
                xs = [r[0] for r in rotation(x)]
                rest = args[1:]
                k_ms = time_cuda(torch, lambda i: fused.bn_act_dropout(xs[i % len(xs)], *rest))
                p_ms = time_cuda(torch, lambda i: fused.bn_act_dropout_reference(
                    xs[i % len(xs)], *rest), windows=1, warmup=1)
                numel = x.numel()
                nbytes = 2 * numel * x.element_size() + 4 * c * 4
                b_ms, bound_by, tb, ti = bounds(nbytes, numel, "bn_act_dropout_fwd_kernel", dtype,
                                                None, p > 0)
                log(f"site {i:2d} C={c:3d} HxW={h}x{w} {str(dtype)[6:]:8s} p={p}: "
                    f"max_abs_err={float(err.max()):.3e} bitwise={bitwise} "
                    f"masks_equal={masks_equal} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                    f"bound_ms={b_ms:.4f} ({bound_by}; bytes {tb:.4f}, instructions {ti:.4f}) "
                    f"GB/s={nbytes / k_ms / 1e6:.0f}")
                if not (bitwise and masks_equal):
                    raise SystemExit(f"site {i}: kernel disagrees with its plain version")
                acc = sums.setdefault((str(dtype)[6:], p), [0.0, 0.0, 0.0, 0.0])
                for j, v in enumerate((k_ms, p_ms, b_ms, tb)):
                    acc[j] += v
                if dtype == torch.float32:
                    summary["max_abs_err"] = max(summary["max_abs_err"], float(err.max()))
                if dtype == torch.float32 and p == 0.0:
                    summary["ms"] += k_ms
                    summary["plain_ms"] += p_ms
                    summary["bound_ms"] += b_ms
                    summary["bytes_ms"] += tb
                    summary["instr_ms"] += ti
                    if bound_by != "bytes":
                        summary["bound_by"] = "operations"
                del y, r, yf, rf, err, xs
        xs = [r[0] for r in rotation(x32)]
        two = time_cuda(torch, lambda i: torch.nn.functional.leaky_relu(
            torch.nn.functional.batch_norm(xs[i % len(xs)], mean, var, scale, bias, False, 0.0,
                                           1e-5), SLOPE), windows=1, warmup=1)
        del xs
        summary["two_call_ms"] += two
        del x32
        torch.cuda.empty_cache()
    for (dt, p), (k, pl, b, tb) in sums.items():
        log(f"sum over the {len(sites)} sites, {dt} p={p}: kernel {k:.4f} ms, plain {pl:.4f} ms, "
            f"bound {b:.4f} ms, byte bound {tb:.4f} ms ({100 * tb / k:.1f}% of the byte bound "
            "reached)")
    log(f"bn_act_dropout over the {len(sites)} sites of one batch-{BATCH} reconstruct (f32, p=0): "
        f"kernel {summary['ms']:.4f} ms, bound {summary['bound_ms']:.4f} ms, plain "
        f"{summary['plain_ms']:.4f} ms; F.leaky_relu(F.batch_norm(...)) as two PyTorch calls "
        f"{summary['two_call_ms']:.4f} ms (yardstick only, not one library call)")
    return summary


TRAIN_BATCH = 4
RUNS = 20   # runs of a reduction kernel that must agree bit for bit

def rotation(*tensors):
    """Tuples of copies of ``tensors`` to cycle through so that back-to-back timed
    launches find their inputs in device memory, not in the 50 MB L2, as the
    bound assumes."""
    size = sum(t.numel() * t.element_size() for t in tensors)
    n = max(1, -(-256 * 2 ** 20 // size))
    # each copy keeps its original's strides: a (B, 256, 256, 1) image made
    # channels_last would not be contiguous, and the wrapper would copy it first
    return [tensors] + [tuple(t.clone() for t in tensors) for _ in range(n - 1)]


def check_close(what, got, ref, dtype, rel_scale=None):
    """max |got - ref| against the stated tolerance: elementwise f32 1e-6 + 1e-6 |ref|,
    bf16 one bf16 ulp of ref; a sum (``rel_scale``) 1e-5 of max(1, max |ref|)."""
    import torch

    g, r = got.float(), ref.float()
    err = (g - r).abs()
    if rel_scale is not None:
        lim = 1e-5 * max(1.0, float(r.abs().max()))
        bad = int((err > lim).sum())
    elif dtype == torch.float32:
        bad = int((err > 1e-6 + 1e-6 * r.abs()).sum())
    else:
        bad = int((err > bf16_ulp(torch, r)).sum())
    if bad:
        raise SystemExit(f"{what}: {bad} elements out of tolerance, max_abs_err {float(err.max()):.3e}")
    return float(err.max()) if err.numel() else 0.0


def twenty_runs(torch, fn, first, busy):
    """``fn()`` :data:`RUNS` times, each result against ``first`` bit for bit: run 6
    shares the card with ``busy()`` on a side stream (another order of blocks), run
    11 goes on the side stream at once with run 12 on this one (two launches in
    flight, each with its own ticket counter)."""
    side = torch.cuda.Stream()
    outs = []
    for i in range(RUNS):
        if i in (5, 10):
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                if i == 5:
                    busy()
                else:
                    outs.append(fn())
                    continue
        outs.append(fn())
    torch.cuda.synchronize()
    return all(all(torch.equal(a, b) for a, b in zip(o, first)) for o in outs)


def phase_train_kernels(torch, sites, latent, bounds):
    """Rows 2-5 against their plain versions at the training step's shapes."""
    import torch.nn.functional as F

    from vaegan_tpu_torch.ops import fused

    log(f"== phase 5: training kernels vs their plain versions (batch {TRAIN_BATCH}, the "
        "notebook step's shapes; kernel: median of 5 CUDA-event windows of 20 launches, inputs "
        "rotated through >= 256 MB; plain and yardstick: one window; tolerances: elementwise f32 "
        "1e-6 + 1e-6|ref|, bf16 1 ulp; sums 1e-5 of max(1, max|ref|); eps 4e-6 absolute; rows "
        f"2, 3 and 5 run {RUNS} times bitwise equal, one run beside a 4096^2 matrix product on a "
        "side stream, one on a side stream at once with another) ==")
    big = torch.randn(4096, 4096, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(9))
    busy = lambda: big @ big  # noqa: E731
    g = torch.Generator(device="cuda").manual_seed(SEED + 1)
    out = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": None,
               "yardstick_ms": 0.0, "max_abs_err": 0.0, "bound_by": "bytes", "bytes_ms": 0.0,
               "instr_ms": 0.0}
           for k in ("bn_act_dropout", "bn_act_dropout_bwd", "reparam_kl", "reparam_kl_bwd",
                     "recon_loss_sums")}
    # rows 1 and 2 in bfloat16 over the sites: kernel ms, bound ms
    bf16 = {"bn_act_dropout": [0.0, 0.0], "bn_act_dropout_bwd": [0.0, 0.0]}

    def note(name, k_ms, p_ms, b, err, y_ms=None):
        o = out[name]
        o["ms"] += k_ms
        o["plain_ms"] += p_ms
        o["bound_ms"] += b[0]
        o["bytes_ms"] += b[2]
        o["instr_ms"] += b[3]
        if b[1] != "bytes":
            o["bound_by"] = "operations"
        o["max_abs_err"] = max(o["max_abs_err"], err)
        if y_ms is not None:
            o["yardstick_ms"] += y_ms

    cl = lambda t: t.contiguous(memory_format=torch.channels_last)  # noqa: E731
    launch_floor = fused._kernel_fn("recon_loss_sums", "vaegan_recon_loss_sums_floor",
                                    (ctypes.c_int, ctypes.c_int, ctypes.c_void_p))
    # ---- row 1: bn_act_dropout forward at the 12 sites of a generator step, each
    # site at the p the step runs it with; each site's bound from its own instance
    for i, (c, h, w) in enumerate(sites):
        p = 0.5 if i % 2 == 0 else 0.0          # bn1 drops at 0.5, bn2 at 0
        vecs = (torch.randn(c, device="cuda", generator=g) * 0.3,
                torch.rand(c, device="cuda", generator=g) + 0.5,
                torch.rand(c, device="cuda", generator=g) + 0.5,
                torch.randn(c, device="cuda", generator=g) * 0.1)
        x32 = cl(torch.randn(TRAIN_BATCH, c, h, w, device="cuda", generator=g))
        for dtype in (torch.float32, torch.bfloat16):
            x = x32.to(dtype)
            args = (*vecs, 8765 + i, SLOPE, p)
            y = fused.bn_act_dropout_forward(x, *args)
            r = fused.bn_act_dropout_reference(x, *args)
            torch.cuda.synchronize()
            if not torch.equal(y, r):
                raise SystemExit(f"row 1 site {i}: y is not bitwise the plain version's")
            rot = rotation(x)
            k_ms = time_cuda(torch, lambda n: fused.bn_act_dropout_forward(rot[n % len(rot)][0], *args))
            p_ms = time_cuda(torch, lambda n: fused.bn_act_dropout_reference(
                rot[n % len(rot)][0], *args), windows=1, warmup=1)
            n = x.numel()
            b = bounds(2 * n * x.element_size() + 4 * c * 4, n, "bn_act_dropout_fwd_kernel", dtype,
                       None, p > 0)
            log(f"row 1 site {i:2d} C={c:3d} HxW={h}x{w} {str(dtype)[6:]:8s} p={p}: y bitwise "
                f"equal, kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={b[0]:.4f} ({b[1]}; "
                f"bytes {b[2]:.4f}, instructions {b[3]:.4f})")
            if dtype == torch.float32:
                note("bn_act_dropout", k_ms, p_ms, b, 0.0)
            else:
                bf16["bn_act_dropout"][0] += k_ms
                bf16["bn_act_dropout"][1] += b[0]
            del y, r, rot
        del x32

    # ---- row 2: bn_act_dropout backward at the 12 sites of a generator step
    for i, (c, h, w) in enumerate(sites):
        p = 0.5 if i % 2 == 0 else 0.0          # bn1 drops at 0.5, bn2 at 0
        mean = torch.randn(c, device="cuda", generator=g) * 0.3
        var = torch.rand(c, device="cuda", generator=g) + 0.5
        scale = torch.rand(c, device="cuda", generator=g) + 0.5
        bias = torch.randn(c, device="cuda", generator=g) * 0.1
        x32 = cl(torch.randn(TRAIN_BATCH, c, h, w, device="cuda", generator=g))
        g32 = cl(torch.randn(TRAIN_BATCH, c, h, w, device="cuda", generator=g))
        seed = 4321 + i
        for dtype in (torch.float32, torch.bfloat16):
            x, gy = x32.to(dtype), g32.to(dtype)
            args = (mean, var, scale, bias, seed, SLOPE, p)
            k = fused.bn_act_dropout_backward(x, gy, *args)
            r = fused.bn_act_dropout_backward_reference(x, gy, *args)
            torch.cuda.synchronize()
            err = check_close(f"row 2 site {i} dx", k[0], r[0], dtype)
            if not torch.equal(k[0], r[0]):
                raise SystemExit(f"row 2 site {i}: dx is not bitwise the plain version's")
            for j, name in enumerate(("dscale", "dbias", "dmean", "dvar"), 1):
                err = max(err, check_close(f"row 2 site {i} {name}", k[j], r[j], dtype, True))
            det = twenty_runs(torch, lambda: fused.bn_act_dropout_backward(x, gy, *args), k, busy)
            y = fused.bn_act_dropout(x, *args)
            dx1 = fused.bn_act_dropout_backward(x, torch.ones_like(y), *args)[0]
            replay = torch.equal(dx1 == 0, y == 0) and (
                p == 0 or torch.equal(y != 0, fused.keep_mask(x, seed, p)))
            if not (det and replay):
                raise SystemExit(f"row 2 site {i}: deterministic={det} mask_replayed={replay}")
            rot = rotation(x, gy)
            call = lambda n: fused.bn_act_dropout_backward(*rot[n % len(rot)], *args)  # noqa: E731
            k_ms = time_cuda(torch, call)
            split = profile_split(torch, call)
            one_kernel(f"row 2 site {i}", split)
            p_ms = time_cuda(torch, lambda n: fused.bn_act_dropout_backward_reference(
                *rot[n % len(rot)], *args), windows=1, warmup=1)
            # yardstick: what PyTorch's own autograd runs for BN -> LeakyReLU ->
            # dropout: the two masks, then native_batch_norm_backward
            inv = torch.rsqrt(var + 1e-5)
            a = (x.float() - mean.view(1, -1, 1, 1)) * (inv * scale).view(1, -1, 1, 1) \
                + bias.view(1, -1, 1, 1)
            keep = (fused.keep_mask(x, seed, p).to(dtype) * fused.keep_scale(p)) if p else None

            def yard(n):
                xx, gg = rot[n % len(rot)]
                gl = gg * keep if keep is not None else gg
                ga = torch.where(a > 0, gl, gl * SLOPE).to(dtype)
                return torch.ops.aten.native_batch_norm_backward(
                    ga, xx, scale, None, None, mean, inv, True, 1e-5,
                    [True, True, True])

            y_ms = time_cuda(torch, yard, windows=1, warmup=1) if dtype == torch.float32 else 0.0
            n = x.numel()
            launch = fused.bwd_launch_for(x, p)
            b = bounds(3 * n * x.element_size() + 8 * c * 4, n, "bn_act_dropout_bwd_kernel", dtype,
                       launch.vec, p > 0)
            log(f"row 2 site {i:2d} C={c:3d} HxW={h}x{w} {str(dtype)[6:]:8s} p={p}: "
                f"max_abs_err={err:.3e} dx_bitwise=True deterministic_x{RUNS}={det} "
                f"mask_replayed={replay} "
                f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} bound_ms={b[0]:.4f} ({b[1]}; bytes "
                f"{b[2]:.4f}, instructions {b[3]:.4f}) yardstick_ms={y_ms:.4f} "
                f"GB/s={3 * n * x.element_size() / k_ms / 1e6:.0f} "
                f"grid={launch.blocks}x{launch.threads} split: {split_text(split)}")
            if dtype == torch.float32:
                note("bn_act_dropout_bwd", k_ms, p_ms, b, err, y_ms)
            else:
                bf16["bn_act_dropout_bwd"][0] += k_ms
                bf16["bn_act_dropout_bwd"][1] += b[0]
            del k, r, y, dx1, rot, a, keep
        del x32, g32
        torch.cuda.empty_cache()

    # ---- rows 3 and 4: reparam_kl at the code processor's (4, 256, 64, 64)
    h, w, c = latent
    shape = (TRAIN_BATCH, c, h, w)
    for dtype in (torch.float32, torch.bfloat16):
        mu = cl(torch.randn(shape, device="cuda", generator=g)).to(dtype)
        lv = cl(torch.randn(shape, device="cuda", generator=g) * 0.5).to(dtype)
        gz = cl(torch.randn(shape, device="cuda", generator=g)).to(dtype)
        gkl = torch.tensor(0.25, device="cuda")
        z, kl = fused.reparam_kl_forward(mu, lv, 77)
        zr, klr = fused.reparam_kl_reference(mu, lv, 77)
        err3 = max(check_close("row 3 z", z, zr, dtype), check_close("row 3 kl", kl, klr, dtype, True))
        if not torch.equal(z, zr):
            raise SystemExit("row 3: z is not bitwise the plain version's")
        errs4 = []
        for gk in (None, gkl):
            k4 = fused.reparam_kl_backward(mu, lv, gz, gk, 77)
            r4 = fused.reparam_kl_backward_reference(mu, lv, gz, gk, 77)
            errs4 += [check_close(f"row 4 {n} gkl={gk is not None}", a, b, dtype)
                      for n, a, b in zip(("dmu", "dlv"), k4, r4)]
        zero = torch.zeros_like(mu, dtype=torch.float32)
        e_fwd, _ = fused.reparam_kl_forward(zero, zero, 5)        # z = 0 + 1 * eps
        _, e_bwd = fused.reparam_kl_backward(zero, zero, torch.full_like(zero, 2.0), None, 5)
        e_plain = fused.reparam_noise(shape, 5, "cuda")
        torch.cuda.synchronize()
        replay = torch.equal(e_fwd, e_bwd)
        e_err = float((e_fwd - e_plain).abs().max())
        det = twenty_runs(torch, lambda: fused.reparam_kl_forward(mu, lv, 77), (z, kl), busy)
        e64 = e_fwd.double()
        mom = (float(e64.mean()), float(e64.var()), float((e64 ** 4).mean()))
        log(f"row 3/4 {str(dtype)[6:]}: z bitwise equal, kl {float(kl)!r} vs plain "
            f"{float(klr)!r}, deterministic_x{RUNS}={det}; backward max_abs_err="
            f"{max(errs4):.3e}; eps "
            f"forward==backward bitwise={replay}, |eps - plain|max={e_err:.3e} (tolerance 4e-6), "
            f"mean={mom[0]:.2e} var={mom[1]:.5f} E[eps^4]={mom[2]:.4f} over {e64.numel()} draws")
        n_el = e64.numel()
        if not (replay and det and e_err <= 4e-6 and abs(mom[0]) < 5 / n_el ** 0.5
                and abs(mom[1] - 1) < 5 * (2 / n_el) ** 0.5):
            raise SystemExit("reparam_kl: noise replay, determinism or moments failed")
        if dtype == torch.float32:
            rot = rotation(mu, lv)
            n = mu.numel()
            call = lambda i: fused.reparam_kl_forward(*rot[i % len(rot)], 77)  # noqa: E731
            k_ms = time_cuda(torch, call)
            split = profile_split(torch, call)
            one_kernel("row 3", split)
            p_ms = time_cuda(torch, lambda i: fused.reparam_kl_reference(*rot[i % len(rot)], 77),
                             windows=1, warmup=1)
            b = bounds(3 * n * 4 + 4, n, "reparam_fwd_kernel", dtype)
            note("reparam_kl", k_ms, p_ms, b, err3)
            launch = fused.reparam_launch_for(mu)
            log(f"row 3 f32 {shape}: kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                f"bound_ms={b[0]:.4f} ({b[1]}; bytes {b[2]:.4f}, instructions {b[3]:.4f}) "
                f"grid={launch.blocks}x{launch.threads} split: {split_text(split)}")
            rot = rotation(mu, lv, gz)
            k_ms = time_cuda(torch, lambda i: fused.reparam_kl_backward(*rot[i % len(rot)], None, 77))
            p_ms = time_cuda(torch, lambda i: fused.reparam_kl_backward_reference(
                *rot[i % len(rot)], None, 77), windows=1, warmup=1)
            b = bounds(5 * n * 4, n, "reparam_bwd_kernel", dtype)
            note("reparam_kl_bwd", k_ms, p_ms, b, max(errs4))
            log(f"row 4 f32 {shape} (gkl None, as on the step): kernel_ms={k_ms:.4f} "
                f"plain_ms={p_ms:.4f} bound_ms={b[0]:.4f} ({b[1]}; bytes {b[2]:.4f}, instructions "
                f"{b[3]:.4f})")
            del rot
        del mu, lv, gz, z, zr, zero, e_fwd, e_bwd, e_plain, e64

    # ---- row 5: recon_loss_sums over (B, 256, 256, 1) pairs: one G step at batch 4 (the
    # kernels line's figures) and at batch 16
    for batch in (TRAIN_BATCH, 16):
        for dtype in (torch.float32, torch.bfloat16):
            r_ = torch.randn(batch, 256, 256, 1, device="cuda", generator=g).to(dtype)
            t_ = torch.rand(batch, 256, 256, 1, device="cuda", generator=g).to(dtype)
            s = fused.recon_loss_sums_forward(r_, t_)
            sr = fused.recon_loss_sums_reference(r_, t_)
            err = check_close(f"row 5 b{batch} sums", s, sr, dtype, True)
            det = twenty_runs(torch, lambda: (fused.recon_loss_sums_forward(r_, t_),), (s,), busy)
            if not det:
                raise SystemExit(f"row 5 b{batch}: {RUNS} runs are not bitwise equal")
            rot = rotation(r_, t_)
            n = r_.numel()
            call = lambda i: fused.recon_loss_sums_forward(*rot[i % len(rot)])  # noqa: E731
            k_ms = time_cuda(torch, call)
            split = profile_split(torch, call)
            one_kernel(f"row 5 b{batch}", split)
            launch = fused.recon_launch_for(r_)

            def floor(i):
                rc = launch_floor(launch.blocks, fused.CLUSTER, fused._stream(r_.device))
                if rc:
                    raise SystemExit(f"the launch-floor kernel failed with CUDA error {rc}")

            floor_ms = time_cuda(torch, floor)
            p_ms = time_cuda(torch, lambda i: fused.recon_loss_sums_reference(*rot[i % len(rot)]),
                             windows=1, warmup=1)
            y_ms = time_cuda(torch, lambda i: (F.l1_loss(*rot[i % len(rot)], reduction="sum"),
                                               F.mse_loss(*rot[i % len(rot)], reduction="sum")),
                             windows=1, warmup=1)
            b = bounds(2 * n * r_.element_size() + 8, n, "recon_sums_kernel", dtype)
            log(f"row 5 b{batch} {str(dtype)[6:]} n={n}: sums {s.tolist()} vs plain {sr.tolist()}, "
                f"max_abs_err={err:.3e}, deterministic_x{RUNS}={det}, kernel_ms={k_ms:.4f} "
                f"plain_ms={p_ms:.4f} bound_ms={b[0]:.4f} ({b[1]}; bytes {b[2]:.4f}, instructions "
                f"{b[3]:.4f}) launch floor (an empty kernel, the same grid) {floor_ms:.4f} ms; "
                f"yardstick F.l1_loss + F.mse_loss (two calls) {y_ms:.4f} ms; "
                f"grid={launch.blocks}x{launch.threads} split: {split_text(split)}")
            if batch == TRAIN_BATCH and dtype == torch.float32:
                note("recon_loss_sums", k_ms, p_ms, b, err, y_ms)
                out["recon_loss_sums"]["floor_ms"] = floor_ms
            del rot
    for name, row in (("1", "bn_act_dropout"), ("2", "bn_act_dropout_bwd")):
        s = out[row]
        log(f"row {name} over the 12 sites of one batch-{TRAIN_BATCH} G step (f32): kernel "
            f"{s['ms']:.4f} ms, bound {s['bound_ms']:.4f} ms ({s['bound_by']}; bytes "
            f"{s['bytes_ms']:.4f}, instructions {s['instr_ms']:.4f}), plain {s['plain_ms']:.4f} ms; "
            f"bf16: kernel {bf16[row][0]:.4f} ms, bound {bf16[row][1]:.4f} ms")
    log(f"row 2 yardstick (masks + native_batch_norm_backward, not one call): "
        f"{out['bn_act_dropout_bwd']['yardstick_ms']:.4f} ms")
    torch.cuda.empty_cache()
    return out


def record_grads(state):
    """Make each optimizer keep the gradients it is stepped with, by name."""
    store = {"g": {}, "d": {}}
    for key, opt, module in (("g", state.opt_g, state.generator), ("d", state.opt_d, state.critic)):
        named, inner = list(module.named_parameters()), opt.step

        def step(*a, _named=named, _inner=inner, _store=store[key], **k):
            _store.clear()
            _store.update({n: p.grad.detach().clone() for n, p in _named})
            return _inner(*a, **k)

        opt.step = step
    return store


def critic_draws(torch, critic, batch, rng, device):
    """Injected critic Dropout2d masks for the four forwards and the GP alphas."""
    from vaegan_tpu_torch.models import ResBlockDiscriminator

    inj = {}
    for fwd in ("real", "fake", "interp", "gen"):
        inj[f"d_masks_{fwd}"] = {
            f"{n}.dropout": (torch.rand((batch, m.conv1.weight_orig.shape[0], 1, 1), generator=rng)
                             >= 0.5).to(device)
            for n, m in critic.named_modules() if isinstance(m, ResBlockDiscriminator)}
    inj["alpha"] = torch.rand(batch, generator=rng).to(device)
    return inj


GRAD_MEDIAN_TOL = 1e-3     # median over a net's tensors of |g_a - g_b|_2 / |g_b|_2
GRAD_MAX_TOL = 1e-2        # max over a net's tensors of max |g_a - g_b| / max |g_net|


def step_errors(a, b):
    """Per net ("g", "d"): (median relative L2 error of its gradient tensors,
    largest element error over the net's largest gradient), and the metrics whose
    relative error exceeds 2e-4 (+1e-5 absolute)."""
    bad = [k for k, want in b["metrics"].items()
           if not abs(a["metrics"][k] - want) <= 1e-5 + 2e-4 * abs(want)]
    out = {}
    for net in ("g", "d"):
        ga, gb = a["grads"][net], b["grads"][net]
        scale = max(float(t.abs().max()) for t in gb.values())
        rel = sorted(float((ga[k] - r).norm()) / max(float(r.norm()), 1e-30) for k, r in gb.items())
        worst = max(float((ga[k] - r).abs().max()) for k, r in gb.items()) / scale
        out[net] = (rel[len(rel) // 2], worst)
    return out, bad


def compare_steps(what, a, b):
    """Hold step record ``a`` against ``b``: every metric within 2e-4 relative
    (+1e-5); per net, the median relative L2 error of the gradient tensors within
    1e-3 and the largest element error within 1e-2 of the net's largest gradient.
    Measured on an H100: a step against itself run twice differs by up to
    2e-4 in the critic (cuDNN's summation order), the fused step against the
    unfused one by 5e-4, a TF32 step against an IEEE one by 5e-3 (generator) and
    2e-2 (critic)."""
    errs, bad = step_errors(a, b)
    ok = not bad and all(m <= GRAD_MEDIAN_TOL and w <= GRAD_MAX_TOL for m, w in errs.values())
    log(f"{what}: generator gradients median rel L2 err {errs['g'][0]:.3e}, max err / max "
        f"grad {errs['g'][1]:.3e}; critic {errs['d'][0]:.3e}, {errs['d'][1]:.3e}; metrics out "
        f"of tolerance {bad}; d_loss {a['metrics']['d_loss']!r} vs {b['metrics']['d_loss']!r}, "
        f"g_loss {a['metrics']['g_loss']!r} vs {b['metrics']['g_loss']!r} -> "
        f"{'agree' if ok else 'DISAGREE'}")
    return ok


def phase_train_step(torch, vt, tf32_defaults):
    """The notebook training step at full width through the port's entry points."""
    from vaegan_tpu_torch.models import layers
    from vaegan_tpu_torch.ops import fused
    from vaegan_tpu_torch.train import fused_draws
    import vaegan_tpu_torch.train.step as step_mod

    cfg = vt.preset("notebook")
    cfg_all = cfg.replace(train=cfg.train.replace(use_pallas="all"))
    cfg_off = cfg.replace(train=cfg.train.replace(use_pallas="off"))
    size = cfg.data.image_size
    log(f"== phase 6: training step, preset('notebook') {size}x{size} batch {TRAIN_BATCH} "
        "float32, use_pallas='all', seeded weights, synthetic batches ==")
    state = vt.create_train_state(cfg_all, device="cuda", seed=SEED)
    n_g = sum(p.numel() for p in state.generator.parameters())
    n_d = sum(p.numel() for p in state.critic.parameters())
    log(f"generator {n_g} parameters, critic {n_d} parameters "
        f"(critic fused: {state.critic.use_pallas}, under the gradient penalty)")
    if (n_g, n_d) != (4_192_783, 139_697_217):
        raise SystemExit("parameter counts differ from the JAX package's")
    data = torch.Generator(device="cuda").manual_seed(SEED)
    batches = [torch.rand((TRAIN_BATCH, size, size, 1), device="cuda", generator=data)
               for _ in range(3)]
    steps = {g: vt.make_train_step(cfg_all, g) for g in (True, False)}
    plan = (True, True, False, True, False, True)
    want = {True: {"bn_act_dropout": 12, "bn_act_dropout_bwd": 12, "reparam_kl": 1,
                   "reparam_kl_bwd": 1, "recon_loss_sums": 1},
            False: {"bn_act_dropout": 12, "bn_act_dropout_bwd": 0, "reparam_kl": 1,
                    "reparam_kl_bwd": 0, "recon_loss_sums": 0}}
    torch.cuda.synchronize()
    fused.reset_launches()
    totals = dict(fused.LAUNCHES)
    for i, do_g in enumerate(plan):
        before = dict(fused.LAUNCHES)
        state, m = steps[do_g](state, batches[i % 3], 1000 + i)
        torch.cuda.synchronize()
        got = {k: fused.LAUNCHES[k] - before[k] for k in before}
        vals = {k: float(v) for k, v in m.items()}
        finite = all(v == v and abs(v) != float("inf") for v in vals.values())
        log(f"step {i} ({'G+D' if do_g else 'D only'}): launches {got}, finite={finite}, "
            + ", ".join(f"{k}={v:.6g}" for k, v in vals.items()))
        if got != want[do_g] or not finite:
            raise SystemExit(f"step {i}: launch counts {got} (want {want[do_g]}) or a non-finite loss")
    main_path = {k: fused.LAUNCHES[k] - totals[k] for k in totals}
    log(f"main path (training): {len(plan)} steps, launches {main_path}")

    # ---- the fused step against the use_pallas='off' step, and TF32 checks
    def one_step(cfg_, dev, batch, inj_extra=None, seed=7):
        """One G step from fresh seeded weights with injected critic draws;
        returns its metrics, its gradients and (fused) its own draws."""
        st = vt.create_train_state(cfg_, device=dev, seed=SEED)
        grads = record_grads(st)
        inj = critic_draws(torch, st.critic, batch.shape[0], torch.Generator().manual_seed(11), dev)
        if inj_extra:
            inj.update({k: ({n: t.to(dev) for n, t in v.items()} if isinstance(v, dict)
                            else v.to(dev)) for k, v in inj_extra.items()})
        x = batch.to(dev)
        st, m = vt.make_train_step(cfg_, True, inject=inj)(st, x, seed)
        if dev == "cuda":
            torch.cuda.synchronize()
        rec = {"metrics": {k: float(v) for k, v in m.items()},
               "grads": {k: {n: t.cpu() for n, t in v.items()} for k, v in grads.items()},
               "draws": fused_draws(st.generator) if cfg_.train.use_pallas == "all" else None}
        del st
        return rec

    x0 = batches[0]
    results = {}
    for flags in ("TF32 off", "default"):
        if flags == "TF32 off":
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        else:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32_defaults
        fused_rec = one_step(cfg_all, "cuda", x0)
        off_rec = one_step(cfg_off, "cuda", x0, inj_extra=fused_rec["draws"])
        if not compare_steps(f"fused vs use_pallas='off' step on the card ({flags} flags)",
                             fused_rec, off_rec):
            raise SystemExit("the fused step disagrees with the unfused step")
        results[flags] = fused_rec
        torch.cuda.empty_cache()
    # the step pins IEEE float32 itself, so under the default flags its gradients are
    # the TF32-off run's up to cuDNN's run-to-run summation order; a step whose
    # convolutions run in TF32 misses the same tolerance
    if not compare_steps("fused step, default flags vs TF32 off", results["default"],
                         results["TF32 off"]):
        raise SystemExit("the step's gradients under PyTorch's default flags are not IEEE float32's")
    saved = step_mod.precision, layers.precision
    step_mod.precision = layers.precision = lambda dtype: contextlib.nullcontext()
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32_rec = one_step(cfg_all, "cuda", x0)
    finally:
        step_mod.precision, layers.precision = saved
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32_defaults
    if compare_steps("diagnostic: the step with its precision pin removed and "
                     "cudnn.allow_tf32=True (TF32 convolutions) vs TF32 off", tf32_rec,
                     results["TF32 off"]):
        raise SystemExit("the tolerance does not tell a TF32 step from an IEEE one")

    # ---- the card against the CPU at a reduced size (64^2, batch 2)
    small = cfg_all.replace(data=cfg_all.data.replace(image_size=64, batch_size=2))
    xs = torch.rand((2, 64, 64, 1), generator=torch.Generator().manual_seed(3))
    t0 = time.perf_counter()
    cpu_rec = one_step(small, "cpu", xs)
    cpu_s = time.perf_counter() - t0
    card_rec = one_step(small, "cuda", xs)
    if not compare_steps(f"card vs CPU, fused step at 64x64 batch 2 (CPU step {cpu_s:.1f} s)",
                         card_rec, cpu_rec):
        raise SystemExit("the card's step disagrees with the CPU's")
    torch.cuda.empty_cache()
    return cfg_all, state, batches, main_path


def phase_train_numbers(torch, vt, cfg_all, state, batches, card_line):
    """Step time and images/s at batch 4 and 16, and where a step's device time goes."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    log(f"== phase 7: training numbers on {card_line} (float32, PyTorch's default flags) ==")
    step = vt.make_train_step(cfg_all, True)
    counter = iter(range(10 ** 6))
    t4 = time_host(torch, lambda: step(state, batches[0], next(counter)), reps=8)
    log(f"train step batch {TRAIN_BATCH}: {t4 * 1e3:.3f} ms median of 8, "
        f"{TRAIN_BATCH / t4:.2f} images/s [{card_line}]")
    big = vt.create_train_state(cfg_all, device="cuda", seed=SEED)
    x16 = torch.rand((16,) + tuple(batches[0].shape[1:]), device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(5))
    torch.cuda.reset_peak_memory_stats()
    t16 = time_host(torch, lambda: step(big, x16, next(counter)), reps=4, warmup=1)
    log(f"train step batch 16: {t16 * 1e3:.3f} ms median of 4, {16 / t16:.2f} images/s, peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB [{card_line}]")
    del big, x16
    torch.cuda.empty_cache()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batches[1], next(counter))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                     reverse=True)
    busy = sum(k[0] for k in kernels)
    if busy == 0:
        log("profiler: no device time recorded")
    else:
        log(f"profile of one batch-{TRAIN_BATCH} G step: wall {wall_ms:.3f} ms (profiler on), "
            f"device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%) [{card_line}]")
        for ms, count, name in kernels[:10]:
            log(f"  {ms:9.3f} ms  x{count:<4d} {name[:110]}")
        for tag, pattern in (("bn_act_dropout", "bn_act_dropout_fwd"),
                             ("bn_act_dropout_bwd", "bn_act_dropout_bwd"),
                             ("reparam_kl", "reparam_fwd"), ("reparam_kl_bwd", "reparam_bwd"),
                             ("recon_loss_sums", "recon_sums")):
            ms = sum(k[0] for k in kernels if pattern in k[2])
            log(f"  {tag}: {ms:.4f} ms of the step's device time ({100 * ms / busy:.2f}%)")
    return t4, t16


def ptxas_summary(report: str):
    """One line per compiled kernel from ``nvcc -Xptxas -v``'s report: the
    registers, shared memory and spills of each entry function."""
    out, name = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            for short in (*KERNEL_INPUTS, "recon_floor_kernel"):
                if short in name:
                    templated = name.split(short)[1].startswith("I")
                    args = ["bf16" if "nv_bfloat16" in name else "f32"] if templated else []
                    args += [v for tag, v in (("Li4E", "4"), ("Li1E", "1"), ("Lb1E", "dropout"),
                                              ("Lb0E", "no dropout")) if tag in name]
                    name = short + (f"<{', '.join(args)}>" if args else "")
                    break
        elif "spill stores" in line and name:
            spills = line.split(":", 1)[-1].strip()
        elif "Used" in line and "registers" in line and name:
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}; {spills}")
            name = None
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    import vaegan_tpu_torch as vt

    if not os.path.abspath(vt.__file__).startswith(HERE + os.sep):
        print(f"chip_smoke: vaegan_tpu_torch imported from {vt.__file__}, not from "
              "this checkout", file=sys.stderr)
        return 1
    from vaegan_tpu_torch.ops import _build, fused
    from vaegan_tpu_torch.serving import load_bundle, save_bundle

    # ---------------------------------------------------------------- phase 1
    log("== phase 1: environment ==")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card_line = smi.splitlines()[0]
    log(card_line)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {kind}, "
        f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs")
    bw = card_bandwidth(kind)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, check=True, timeout=60).stdout.split()[0]
    instr_rate = sms * LANES_PER_SM * float(clock) * 1e6
    log(f"bounds: data-sheet memory rate {bw / 1e12:.2f} TB/s; instruction rate {sms} SMs x "
        f"{LANES_PER_SM} lanes x {clock} MHz (max SM clock) = {instr_rate / 1e12:.2f} T "
        "instructions/s, over each kernel's hot-loop instructions per element (SASS)")
    tf32_defaults = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("TF32 off for cuDNN convolutions and matmuls for the parity phases (PyTorch's "
        f"defaults: cudnn.allow_tf32={tf32_defaults[0]}, matmul.allow_tf32={tf32_defaults[1]}, "
        "restored for the repeat of phase 3's model comparisons and for phase 4)")
    t0 = time.perf_counter()
    libs = _build.build_all()
    build = [f"kernel build ({len(libs)} sources, one nvcc each, started together): "
             f"{time.perf_counter() - t0:.2f} s"]
    for name, lib in libs.items():
        build.append(f"-- {name}: {os.path.relpath(lib, HERE)} (compiler report: {lib}.log)")
        with open(f"{lib}.log") as f:
            build += [f"   {line}" for line in ptxas_summary(f.read())]
    counts, atomics = kernel_counts(libs, os.path.join(os.path.dirname(_build.find_nvcc()),
                                                       "cuobjdump"))
    build.append("instructions per element on each kernel's hot path (cuobjdump -sass): " +
                 ", ".join(f"{k[0]}<{', '.join(str(a) for a in k[1:] if a is not None)}> {v:.2f}"
                           for k, v in sorted(counts.items(), key=str)))
    build.append(f"float atomics in the kernels: {atomics or 'none'}")
    for line in build:
        log(line)
    if atomics:
        raise SystemExit("a kernel holds a float atomic: its sums would change from run to run")
    bounds = Bounds(bw, instr_rate, counts)

    # ---------------------------------------------------------------- models
    cfg = vt.preset("vaegan_infer")
    cfg_all = cfg.replace(train=cfg.train.replace(use_pallas="all"))
    cfg_off = cfg.replace(train=cfg.train.replace(use_pallas="off"))
    size, ch = cfg.data.image_size, cfg.generator.in_channels
    state = vt.create_generator_state(cfg_all, device="cuda", seed=SEED)
    gen = state.generator
    g_cpu = torch.Generator().manual_seed(SEED)
    with torch.no_grad():   # non-trivial running statistics, so eval BN is tested
        for name, buf in gen.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(torch.randn(buf.shape, generator=g_cpu) * 0.1)
            elif name.endswith("running_var"):
                buf.copy_(torch.rand(buf.shape, generator=g_cpu) + 0.5)
    counts = {part: sum(p.numel() for p in getattr(gen, part).parameters())
              for part in ("encoder", "decoder", "code_processor")}
    log(f"vaegan_infer generator parameters: {counts}")
    if counts != {"encoder": 1_514_754, "decoder": 1_497_869, "code_processor": 1_180_160}:
        raise SystemExit("parameter counts differ from the JAX package's")
    sites = fused_sites(torch, gen, size, ch)
    if len(sites) != 12:
        raise SystemExit(f"expected 12 fused BN sites per reconstruct, found {len(sites)}")

    # ---------------------------------------------------------------- phase 2
    summary = phase_kernel(torch, sites, bounds)

    # ---------------------------------------------------------------- phase 3
    log(f"== phase 3: served model vaegan_infer, {size}x{size}, float32, use_pallas='all' ==")
    images = torch.rand((BATCH, size, size, ch), generator=g_cpu).cuda()
    z8 = torch.randn((8,) + vt.latent_shape(cfg), generator=g_cpu).cuda()
    with tempfile.TemporaryDirectory(prefix="vaegan_bundle_") as bundle_dir:
        save_bundle(bundle_dir, cfg_all, state)
        bundle = load_bundle(bundle_dir, device="cuda")
    sample_gen = torch.Generator(device="cuda").manual_seed(SEED)

    def launches():
        torch.cuda.synchronize()
        return fused.LAUNCHES["bn_act_dropout"]

    requests = [
        ("reconstruct b1", 12, lambda: vt.reconstruct(cfg_all, state, images[:1])),
        ("reconstruct b8", 12, lambda: vt.reconstruct(cfg_all, state, images[:8])),
        ("reconstruct b64", 12, lambda: vt.reconstruct(cfg_all, state, images)),
        ("bundle.encode b8", 6, lambda: bundle.encode(images[:8])),
        ("bundle.decode b8", 6, lambda: bundle.decode(z8)),
        ("sample n=25", 6, lambda: vt.sample(cfg_all, state, sample_gen, n=25)),
        ("interpolate 4+4 x 8 steps", 18,
         lambda: vt.interpolate(cfg_all, state, images[:4], images[4:8], steps=8)),
        ("bundle.reconstruct b8", 12, lambda: bundle.reconstruct(images[:8])),
    ]
    fused.reset_launches()
    outputs = {}
    for name, want, fn in requests:
        before = launches()
        outputs[name] = fn()
        got = launches() - before
        out = outputs[name]
        tensors = out if isinstance(out, tuple) else (out,)
        finite = all(bool(torch.isfinite(t).all()) for t in tensors)
        log(f"{name}: shapes {[tuple(t.shape) for t in tensors]}, finite={finite}, "
            f"bn_act_dropout launches {got} (want {want})")
        if got != want or not finite:
            raise SystemExit(f"{name}: wrong launch count or non-finite output")
    main_path_launches = launches()
    log(f"main path: {main_path_launches} bn_act_dropout launches "
        f"(want {sum(w for _, w, _ in requests)})")
    if main_path_launches != sum(w for _, w, _ in requests):
        raise SystemExit("main path launch count is wrong")
    # the bundle must carry the weights bit for bit; its outputs then agree with
    # the direct call to within 1e-5 of the output's scale, not bit for bit:
    # cuDNN's transposed-conv (backward-data) algorithms may sum with atomics,
    # so two runs of one model need not be bitwise equal (printed beside it)
    sd, sd_b = gen.state_dict(), bundle.generator.state_dict()
    weights_equal = sd.keys() == sd_b.keys() and all(torch.equal(sd[k], sd_b[k]) for k in sd)
    r8, mse8 = outputs["reconstruct b8"]
    rb8, mseb8 = outputs["bundle.reconstruct b8"]
    r8_again, _ = vt.reconstruct(cfg_all, state, images[:8])
    err, rerun = float((rb8 - r8).abs().max()), float((r8_again - r8).abs().max())
    log(f"bundle round trip: weights bitwise equal={weights_equal}; reconstruct b8 "
        f"bitwise equal={torch.equal(r8, rb8)}, max_abs_err={err:.3e} (direct call run "
        f"twice: max_abs_diff={rerun:.3e}); mse {float(mse8)!r} vs {float(mseb8)!r}")
    if not (weights_equal and err <= 1e-5 * float(r8.abs().max())):
        raise SystemExit("the serving bundle does not reconstruct identically")

    # the same weights through the plain path: unfused BN + LeakyReLU on the card.
    # Tolerance 1e-4 x max|ref|: both sides run the same cuDNN convolutions and
    # differ only in how BN rounds ((x-mean)*(inv*scale)+bias in the kernel vs
    # x*(scale*inv)+(bias-mean*scale*inv) unfused), about 1 f32 ulp of the
    # activation per site; 12 sites and 6 residual sums keep that near 1e-6 of
    # the output's scale, so 1e-4 leaves two orders of margin. The CPU model
    # (plain versions, oneDNN convolutions) is held to the same tolerance.
    gen_off = vt.build_generator(cfg_off, device="cuda")
    gen_off.load_state_dict(gen.state_dict(), strict=True)
    state_off = state.replace(generator=gen_off)
    gen_cpu = vt.build_generator(cfg_all, device="cpu")
    gen_cpu.load_state_dict({k: v.cpu() for k, v in gen.state_dict().items()}, strict=True)
    state_cpu = state.replace(generator=gen_cpu)
    r_cpu, mse_cpu = vt.reconstruct(cfg_all, state_cpu, images[:2].cpu())

    def model_parity(flags):
        checks = [
            ("use_pallas all vs off, reconstruct b64",
             lambda: vt.reconstruct(cfg_all, state, images)[0],
             lambda: vt.reconstruct(cfg_off, state_off, images)[0]),
            ("use_pallas all vs off, encode b8", lambda: bundle.encode(images[:8]),
             lambda: gen_off.encode(images[:8])),
            ("use_pallas all vs off, decode b8", lambda: bundle.decode(z8),
             lambda: gen_off.decode(z8)),
            ("card vs CPU, reconstruct b2",
             lambda: vt.reconstruct(cfg_all, state, images[:2])[0].cpu(), lambda: r_cpu),
        ]
        with torch.inference_mode():
            for name, got_fn, ref_fn in checks:
                got, ref = got_fn(), ref_fn()
                err, scale = float((got - ref).abs().max()), float(ref.abs().max())
                log(f"{name} ({flags}): max_abs_err={err:.3e}, max|ref|={scale:.3e}, "
                    f"tolerance {1e-4 * scale:.3e}")
                if not err <= 1e-4 * scale:
                    raise SystemExit(f"{name} ({flags}): the outputs disagree")

    model_parity("TF32 off")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32_defaults
    model_parity(f"PyTorch's default flags, cudnn.allow_tf32={tf32_defaults[0]}")
    _, mse_gpu = vt.reconstruct(cfg_all, state, images[:2])
    log(f"card vs CPU, reconstruct b2: mse {float(mse_gpu)!r} vs {float(mse_cpu)!r}")
    del gen_off, state_off, gen_cpu, state_cpu, outputs
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- phase 4
    log(f"== phase 4: numbers on {card_line} (float32, PyTorch's default flags) ==")
    t64 = time_host(torch, lambda: vt.reconstruct(cfg_all, state, images), reps=10)
    t1 = time_host(torch, lambda: vt.reconstruct(cfg_all, state, images[:1]), reps=50, warmup=5)
    ts = time_host(torch, lambda: vt.sample(cfg_all, state, sample_gen, n=25), reps=10)
    log(f"reconstruct batch {BATCH}: {t64 * 1e3:.3f} ms median, {BATCH / t64:.1f} images/s [{card_line}]")
    log(f"reconstruct batch 1 latency: {t1 * 1e3:.3f} ms median of 50 [{card_line}]")
    log(f"sample n=25: {ts * 1e3:.3f} ms median, {25 / ts:.1f} images/s [{card_line}]")
    log(f"bn_act_dropout per batch-{BATCH} reconstruct: {summary['ms']:.4f} ms of "
        f"{t64 * 1e3:.3f} ms ({100 * summary['ms'] / (t64 * 1e3):.1f}%), bound "
        f"{summary['bound_ms']:.4f} ms [{card_line}]")

    # where the time of one batch-64 reconstruct goes, by kernel (torch.profiler)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        vt.reconstruct(cfg_all, state, images)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: the CPU-side aten ops also carry the device time
    # of the kernels they launch, and counting both would count it twice
    from torch.autograd import DeviceType

    kernels = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                     reverse=True)
    busy = sum(k[0] for k in kernels)
    if busy == 0:
        log("profiler: no device time recorded")
    else:
        bn = sum(k[0] for k in kernels if "bn_act_dropout" in k[2])
        log(f"profile of one reconstruct b{BATCH}: wall {wall_ms:.3f} ms (profiler on), device "
            f"busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%), bn_act_dropout {bn:.3f} ms "
            f"({100 * bn / busy:.1f}% of device time) [{card_line}]")
        for ms, count, name in kernels[:10]:
            log(f"  {ms:9.3f} ms  x{count:<3d} {name[:110]}")

    # ---------------------------------------------------------------- phases 5-7
    train_kernels = phase_train_kernels(torch, sites, vt.latent_shape(cfg), bounds)
    cfg_train, train_state, batches, train_launches = phase_train_step(torch, vt, tf32_defaults)
    t4, t16 = phase_train_numbers(torch, vt, cfg_train, train_state, batches, card_line)
    log(f"summary [{card_line}]: serving reconstruct b{BATCH} {BATCH / t64:.1f} images/s; "
        f"training step b{TRAIN_BATCH} {t4 * 1e3:.3f} ms = {TRAIN_BATCH / t4:.2f} images/s, "
        f"b16 {t16 * 1e3:.3f} ms = {16 / t16:.2f} images/s")

    # row 1's top-level figures are the training path's, as its launches are; both
    # paths' figures stand beside them
    src = "vaegan_tpu_torch/csrc/"
    train_row1 = train_kernels["bn_act_dropout"]
    rows = [{
        "name": "bn_act_dropout", "route": "cuda", "source": src + "bn_act_dropout.cu",
        "replaces": "vaegan_tpu/ops/pallas_fused.py:80",
        "launches": train_launches["bn_act_dropout"],
        "launches_by_path": {"serving": main_path_launches,
                             "training": train_launches["bn_act_dropout"]},
        "ms_by_path": {"serving": summary["ms"], "training": train_row1["ms"]},
        "bound_by_path": {"serving": summary["bound_ms"], "training": train_row1["bound_ms"]},
        "max_abs_err": summary["max_abs_err"], "ms": train_row1["ms"],
        "plain_ms": train_row1["plain_ms"], "bound_ms": train_row1["bound_ms"],
        "bound_by": train_row1["bound_by"], "library_ms": None,
        "bound_bytes_ms": train_row1["bytes_ms"], "bound_instr_ms": train_row1["instr_ms"],
    }]
    for name, source, line in (("bn_act_dropout_bwd", "bn_act_dropout.cu", 95),
                               ("reparam_kl", "reparam_kl.cu", 244),
                               ("reparam_kl_bwd", "reparam_kl.cu", 262),
                               ("recon_loss_sums", "recon_loss_sums.cu", 373)):
        k = train_kernels[name]
        rows.append({"name": name, "route": "cuda", "source": src + source,
                     "replaces": f"vaegan_tpu/ops/pallas_fused.py:{line}",
                     "launches": train_launches[name], "max_abs_err": k["max_abs_err"],
                     "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"], "library_ms": k["library_ms"],
                     "bound_bytes_ms": k["bytes_ms"], "bound_instr_ms": k["instr_ms"]})
    # the least any one-launch kernel on row 5's grid takes: an empty kernel's time
    rows[-1]["launch_floor_ms"] = train_kernels["recon_loss_sums"]["floor_ms"]
    for line in build:      # again here: the start of a long log may be cut off
        log(line)
    log(card_line)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 1:
        sys.exit("usage: chip_smoke.py")
    sys.exit(main())
