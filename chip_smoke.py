#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``vaegan_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. environment: the card, its power limit, torch/CUDA versions; builds every CUDA
   kernel from ``vaegan_tpu_torch/csrc`` (one ``nvcc`` per source, started
   together) and prints registers and spills per kernel; counts each kernel's
   hot-loop instructions per element in its SASS (``cuobjdump -sass``; the
   fewest that a vector pass can run), whose SASS issue time (over SMs x 128
   lanes x the maximum SM clock) is printed beside every bound (the larger of
   the bytes over the data-sheet memory rate and the algorithm's operations
   over the data sheet's float32 rate), and fails if any kernel
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
   bit by the backwards, row 4 without a KL cotangent bitwise a zero one on
   special values (signed zeros, e^lv overflow, NaN); row 4 also on one
   resident wave and SMs x 8 blocks; rows 2, 3 and 5 (one launch each, a grid reduction
   inside) run twenty times bitwise equal, one run beside a matrix product on a
   side stream and one on a second stream at once, and show one kernel and no
   other under torch.profiler (its device time printed beside the call's);
   kernel / plain / yardstick times beside each bound and SASS issue time,
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
   kernels of a profiled step, the device-busy share, each kernel's share;
8. the training loop: ``vt.train`` on the notebook preset (full width,
   ``use_pallas="all"``) over 32 synthetic images (2 epochs, 16 steps; a grid, a
   checkpoint and a flush every 4 steps, the NaN guard on). First the feeds: the
   ``hbm_cache`` loader and ``DataLoader`` + ``device_prefetch`` give bitwise
   equal batches (once with the consumer lagging), the native NIfTI decoder
   (built from ``csrc/nifti_reader.cc`` with the host compiler) agrees with the
   Python one on 16 files at 300x300 within 1e-6, and a ``CachedDataset``
   epoch equals its decode. Then the loop with its launch counts per step
   (phase 6's plus the sampler's forward on grid steps), finite metrics, 4
   grids and the last 3 checkpoints; the sampler leaves the state bitwise as it
   was; a run stopped at step 8 and resumed matches the uninterrupted run's
   losses, and a checkpoint round trip is bitwise. Numbers: loop images/s with
   each feed beside the bare step's, the device-busy share of 4 profiled loop
   steps, host syncs per step outside the metric flush;
9. the Larsen three-optimizer step: ``preset("vaegan_paper")`` (96², batch 4,
   float32, the notebook critic fused at its 7 BN sites: BCE with no penalty)
   with ``use_pallas="all"``. Rows 1-2 at each critic site (slope 0.2, p = 0)
   bitwise against their plain versions and timed beside their bounds; six
   ``make_paper_train_step`` steps with exact launch counts; the fused step
   against the ``use_pallas="off"`` step with the masks of both generator
   forwards (x~ and the prior decode) and the critic's injected, under both flag
   settings; step ms and images/s and a profiled step; ``vt.train`` of the
   preset stopped at step 4 and resumed to 6 (grids, checkpoints, launches per
   step: the paper path); ``grad_accum=2`` of each scheme on duplicated
   microbatches at dropout 0 against the full-batch step, and one accumulating
   notebook step with its launches counted (the accum path, all five kernels);
10. critic batching and the single-card surface. 10.1: the notebook step at
   full width with ``critic_batching`` "separate", "concat" and "concat3"
   (four steps each with exact launch counts, step ms and peak memory side by
   side); ``vaegan_paper`` under "concat" (four steps: one fused critic forward
   over batch 12, 25 / 45 / 1 / 1 / 0 launches a step); rows 1-2 at the
   critic's 7 sites over batch 12, as phase 9.1; the fused concat paper step
   against the unfused one with its generator draws replayed. 10.2: the CLI,
   each command in its own process: ``print-config`` (its JSON, with
   ``use_pallas`` "all", configures the rest), ``train`` of the notebook
   preset for 4 steps with its launches counted (all five kernels),
   ``eval``, ``sample``, ``interpolate``, ``export`` then ``import`` (bitwise
   round trip), ``export-serving`` and a ``load_bundle`` reconstruct,
   ``search`` (one trial at 64²). 10.3: each mode of ``python -m
   vaegan_tpu_torch.bench`` (its JSON line) and ``entry()``'s forward;
11. data-parallel training: ``preset("vaegan_256_dp")`` (256², bfloat16, the
   notebook generator and 139.7 M-parameter critic) with ``use_pallas="all"``
   and ``remat`` on, at the largest global batch of 64 / 32 / 16 whose step
   fits (the cut printed), through ``parallel.train.train_data_parallel`` on
   a one-process NCCL group (the degenerate mesh): 11.1 two steps (G+D with a
   grid, critic only) that save a checkpoint, a resume that restores it
   bitwise, two more steps, each step's launches exact (a remat G+D step runs
   row 1 24 times), step ms, peak memory and a profiled step; 11.2 remat on
   against off at batch 16 (step ms, peak memory); 11.3 rows 1-4 with a
   non-zero index base at the DP step's bfloat16 sites bitwise against their
   plain versions, timed beside their bounds (inputs rotated, as in every
   kernel timing); 11.4 two gloo processes on the
   one card against this process's one-rank step (float32, global batch 8;
   the CPU test's tolerances), with the all-reduce time a step; 11.5 ``cli
   train --dp`` under ``torchrun --nproc_per_node=1``, its launches counted;
12. the data x model mesh (``vaegan_256_dp`` at full width; every multi-process
   run uses gloo through the host, since NCCL refuses two ranks on one card, so
   these runs check correctness and say nothing of NVLink): 12.1 a 2 x 2 mesh
   (tensor parallelism of the critic head and H split over the model axis),
   four gloo processes on the card, two float32 steps at global batch 8 held
   against this process's one-rank step as 11.4 holds two ranks, with each
   process's halo / gather / sum time a step; 12.2 rows 1-4 on rank (1, 1)'s
   rows and H stripe of the DP step's bfloat16 sites at batch 32 (the stripe
   index map), bitwise against their plain versions and against the kernel
   on the global tensor, timed beside their bounds; 12.3 tensor parallelism
   alone through ``train_data_parallel`` (``parallel.num_model`` 2, two gloo
   processes): 11.1's runs with each step's launches exact, and the saved
   checkpoint restored into one process; 12.4 ``cli train --dp`` with
   ``num_model`` 2 under ``torchrun --nproc_per_node=2`` (gloo), launches
   counted, and ``entry.dryrun_multichip(4)`` on the CPU while it runs;
13. the last of the JAX surface: 13.1 ``python -m vaegan_tpu_torch.bench
   --roofline`` with ``BENCH_PALLAS=all`` on the notebook G+D step, ``--paper``
   and ``BENCH_CRITIC_ONLY=1`` (96², batch 128, bfloat16): each JSON line, the
   triad one kernel a repetition under torch.profiler, no triad above the data
   sheet's rate x 1.05, no step above the achieved rate x 1.05, the counted
   bytes at least the parameters', gradients' and optimizer state's, the
   counted step's kernel calls exactly the step's launches; the counted flops
   beside an analytic count of the forwards' convolutions and linears; 13.2
   ``vaegan_infer`` bundles exported with ``torch.export`` on the card (a
   symbolic batch, and one pinned at 64) and on the CPU for ("cpu", "cuda"),
   each loaded on the card: reconstruct at batch 64 and 1, encode and decode
   held against the in-process entry points within 1e-6 of the output's
   scale, 12 row-1 launches a reconstruct from the loaded program, the pinned
   bundle refusing batch 1; the bundle's images/s at batch 64 and batch-1
   latency beside phase 4's;
14. the user journeys (``python -m vaegan_tpu_torch.examples.*``), each in its
   own process, the independent ones started together: 14.1
   ``reproduce_headline`` at 256², batch 4, float32, ``--use-pallas all``, 8
   steps, 3 draws and BN recalibrated from 5 batches, for ``notebook``,
   ``--vae`` and ``--preset vaegan_paper`` (each JSON line parsed, every number
   finite, the paper run's EMA draws present, ``fused.LAUNCHES`` over the
   train held to 8 steps' and the sampler's: the journey path); 14.2
   ``train_vaegan --epochs 1 --image-size 96 --batch-size 64`` (its three
   PNGs and a finite MSE); 14.3 ``train_multichip --virtual 2 --max-steps 4``
   (two gloo processes sharing the card) and under ``torchrun
   --nproc_per_node=1`` (NCCL, a world of one), each closing line; 14.4 the
   ``hbm_cache`` loader in two gloo processes on the card, every batch of one
   epoch with ``grad_accum`` 2 bitwise the rank-sharded host loader's. The
   phase's wall is printed on a line of its own;
15. the research tools (``python -m vaegan_tpu_torch.tools.*``), each in its
   own process through :func:`counted_tool` (which appends its kernel
   launches to a log), in two waves of processes started together:
   ``edges_multiseed --seeds 1`` (one epoch at 64², batch 64; its two
   ``reproduce_headline`` runs counted in their own processes),
   ``paper_probe --keep-best`` on 24 files of ``make_nifti_dataset`` (which
   runs first, in this process; 256², batch 4, 20 steps, EMA 0.999,
   visuals), both byte audits at their defaults (``conv_fusion_evidence``
   with kernels off and on, and ``paper_loss_fusion_evidence`` without and
   with ``--pallas``), ``gan_only_budget --keep-best`` (20 steps) and
   ``run_256dp_virtual_mesh`` (two gloo processes, global batch 8, float32,
   as 11.4); then ``large_batch_recipe`` (4 steps at batch 64) and
   ``profile_step_residual --steps 2``. Each tool's JSON and files are
   checked, its launches must be exactly :func:`tool_launches`' (the tool
   paths), and each process's peak memory is printed. The phase's wall is
   printed on a line of its own.

The second-to-last line is a JSON object describing each kernel; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import io
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))

# Data-sheet memory rate, bytes/s: the byte side of every bound.
CARD_BANDWIDTH = {
    "H100 PCIe": 2.0e12,
    "H100": 3.35e12,      # SXM5 80 GB
}
# thread-instructions an SM starts per clock (4 schedulers x 32 lanes): a kernel's
# SASS issue time is its hot loop's instruction count over SMs x this x clock
LANES_PER_SM = 128
# the data sheet's float32 rate outside the tensor cores (H100 SXM, 700 W): the
# operations side of every bound, over each kernel's algorithm's operations
# (``fused.kernel_cost``; the kernels compute in float32 for either input type)
OPS_RATE = 67e12
# ``fused.LAUNCHES`` name of each kernel function
KERNEL_NAMES = {"bn_act_dropout_fwd_kernel": "bn_act_dropout",
                "bn_act_dropout_bwd_kernel": "bn_act_dropout_bwd",
                "reparam_fwd_kernel": "reparam_kl", "reparam_bwd_kernel": "reparam_kl_bwd",
                "recon_sums_kernel": "recon_loss_sums"}

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
# the arrays each kernel's hot loop reads, each with wide (8- or 16-byte) loads
KERNEL_INPUTS = {"bn_act_dropout_fwd_kernel": 1, "bn_act_dropout_bwd_kernel": 2,
                 "reparam_fwd_kernel": 2, "reparam_bwd_kernel": 3, "recon_sums_kernel": 2}
# each kernel's bool template arguments, in order
KERNEL_FLAGS = {"bn_act_dropout_fwd_kernel": ("dropout", "striped"),
                "bn_act_dropout_bwd_kernel": ("dropout", "striped"),
                "reparam_fwd_kernel": ("striped",), "reparam_bwd_kernel": ("striped", "kl"),
                "recon_sums_kernel": ()}


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


def _wide_bytes(ins):
    """Bytes of a wide (8- or 16-byte) global load, else 0."""
    m = WIDE_LOAD.match(ins)
    return int(m.group(2)) // 8 if m else 0


def hot_loop_instructions(code, inputs, elem_bytes=4):
    """Instructions per element on the hot path of a kernel's grid-stride loop, as a
    lower bound. The loop is the backward branch whose body holds the most 16- or
    8-byte global loads. Of the paths from its head to that branch, the count takes
    the one that loads the most bytes with them (the aligned vector path) and, of
    those, the fewest instructions: every forward branch that can skip work (a slow
    path such as cosf's Payne-Hanek reduction or sqrtf's special cases, a dropout
    branch decided at run time) counts as skipping it, so no branch that is not
    taken can raise the count. A branch out of the loop falls through; a nested
    loop's body counts at most once. Elements per pass: the bytes of the path's wide
    loads over the ``inputs`` arrays read, at ``elem_bytes`` an element (a 16-byte
    load is 4 float32 or 8 bfloat16 elements)."""
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
    # best[i]: (-wide load bytes, instructions) of the best path from i to the back branch
    best = {end: (-_wide_bytes(code[end][1]), 1)}
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
            best[i] = (w - _wide_bytes(ins), n + 1)
    if head not in best or best[head][0] == 0:
        return None
    wide, executed = best[head]
    return executed * inputs * elem_bytes / -wide


def kernel_counts(libs, cuobjdump):
    """From ``cuobjdump -sass`` of each built library: {(kernel, dtype, vec,
    dropout, striped, kl): instructions per element} of every kernel instance with
    a vectorised loop (vec, dropout and kl None, striped False, where the kernel
    has no such template argument), and the names of the kernels that hold a float
    atomic."""
    counts, atomics = {}, []
    for lib in libs.values():
        text = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True,
                              check=True, timeout=120).stdout
        for name, code in sass_functions(text).items():
            if any(FLOAT_ATOMIC.search(x) for _, x in code):
                atomics.append(name)
            for kernel, inputs in KERNEL_INPUTS.items():
                m = re.search(kernel + r"I(13__nv_bfloat16|f)(?:Li(\d)E)?((?:Lb\dE)*)", name)
                if m:
                    break
            else:
                continue
            dtype = "bfloat16" if m.group(1).startswith("13") else "float32"
            n = hot_loop_instructions(code, inputs, 2 if dtype == "bfloat16" else 4)
            if n is not None:
                flags = dict(zip(KERNEL_FLAGS[kernel],
                                 (f == "1" for f in re.findall(r"Lb(\d)E", m.group(3)))))
                counts[(kernel, dtype, int(m.group(2)) if m.group(2) else None,
                        flags.get("dropout"), flags.get("striped", False), flags.get("kl"))] = n
    return counts, atomics


class Bounds:
    """The least time of a kernel's work on this card, the larger of two: the bytes
    it must move (each input read once, each output written once) over the
    data-sheet memory rate, and its algorithm's operations
    (``fused.ops_per_element`` times the elements) over the data sheet's float32
    rate, :data:`OPS_RATE`. Beside it, not part of it, the kernel's SASS issue
    time: the instructions its hot loop runs per element (:func:`kernel_counts`)
    times the elements over the instruction rate, SMs x 128 lanes x the SM's
    maximum clock."""

    def __init__(self, bw, instr_rate, counts):
        self.bw, self.instr_rate, self.counts = bw, instr_rate, counts

    def __call__(self, nbytes, n, kernel, dtype, vec=None, dropout=None, striped=False,
                 kl=None):
        """(least ms, "bytes" or "operations", byte ms, SASS issue ms, operations
        ms) of the kernel's instance for a contiguous or a ``striped`` index
        map (row 4: ``kl``, with a KL cotangent or not; a build whose row 4 has
        no such instance counts its one loop)."""
        from vaegan_tpu_torch.ops import fused

        tb = nbytes / self.bw
        to = fused.ops_per_element(KERNEL_NAMES[kernel], 2 if "bfloat16" in str(dtype) else 4,
                                   bool(dropout)) * n / OPS_RATE
        key = (kernel, str(dtype)[6:], vec, dropout, striped)
        count = self.counts.get(key + (kl,)) or self.counts[key + (None,)]
        ti = count * n / self.instr_rate
        return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations", tb * 1e3, ti * 1e3,
                to * 1e3)


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


# profiles of one function tried before profile_split gives up on an empty one
PROFILE_ATTEMPTS = 4


def profile_split(torch, fn, calls=20):
    """{kernel name: (device ms per launch, launches recorded)} of every kernel that
    ``fn(i)`` launches, under torch.profiler over ``calls`` calls after one warm-up
    (the profiler may drop some of a run's device events, so a kernel's launches
    recorded can fall short of its launches). A profile with no device event at
    all is taken again, up to ``PROFILE_ATTEMPTS`` in all, and then fails, so
    that no check passes on an empty profile."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn(0)
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
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
        if out:
            return {name: (ms / count, count) for name, (ms, count) in out.items()}
        log(f"torch.profiler recorded no device event in {calls} calls (profile {attempt} "
            f"of {PROFILE_ATTEMPTS})")
    raise SystemExit(f"torch.profiler recorded no device event in {PROFILE_ATTEMPTS} profiles")


def split_text(split, calls=20):
    return ", ".join(f"{name} {ms:.4f} ms a launch ({count} launches recorded in {calls} calls)"
                     for name, (ms, count) in split.items())


def one_kernel(what, split):
    """Fail if the profile of a kernel's calls shows a second kernel."""
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
                b_ms, bound_by, tb, ti, _ = bounds(nbytes, numel, "bn_act_dropout_fwd_kernel",
                                                   dtype, None, p > 0)
                log(f"site {i:2d} C={c:3d} HxW={h}x{w} {str(dtype)[6:]:8s} p={p}: "
                    f"max_abs_err={float(err.max()):.3e} bitwise={bitwise} "
                    f"masks_equal={masks_equal} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                    f"bound_ms={b_ms:.4f} ({bound_by}; bytes {tb:.4f}, SASS issue {ti:.4f}) "
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
        f"kernel {summary['ms']:.4f} ms, bound {summary['bound_ms']:.4f} ms (SASS issue "
        f"{summary['instr_ms']:.4f} ms), plain "
        f"{summary['plain_ms']:.4f} ms; F.leaky_relu(F.batch_norm(...)) as two PyTorch calls "
        f"{summary['two_call_ms']:.4f} ms (yardstick only, not one library call)")
    return summary


TRAIN_BATCH = 4
RUNS = 20   # runs of a reduction kernel that must agree bit for bit
# kernel launches of one notebook train step, G+D (True) and critic-only (False)
STEP_LAUNCHES = {
    True: {"bn_act_dropout": 12, "bn_act_dropout_bwd": 12, "reparam_kl": 1,
           "reparam_kl_bwd": 1, "recon_loss_sums": 1},
    False: {"bn_act_dropout": 12, "bn_act_dropout_bwd": 0, "reparam_kl": 1,
            "reparam_kl_bwd": 0, "recon_loss_sums": 0}}
# the loop's sampler: one train-mode generator forward on a grid step
SAMPLER_LAUNCHES = {"bn_act_dropout": 12, "bn_act_dropout_bwd": 0, "reparam_kl": 1,
                    "reparam_kl_bwd": 0, "recon_loss_sums": 0}
# one vaegan_paper step (critic fused, no GP). Forwards: the generator's 12
# sites, the prior decode's 6, the critic's 7 in each of 3 forwards. Backwards:
# each group's autograd.grad crosses the sites on its way to its parameters:
# encoder 7 (critic on x~) + 6 (decoder on x~) + 6 (encoder); decoder 7 + 7
# (critic on x~ and x_p) + 6 + 6 (decoder on x~ and x_p); critic 21
PAPER_LAUNCHES = {"bn_act_dropout": 39, "bn_act_dropout_bwd": 66, "reparam_kl": 1,
                  "reparam_kl_bwd": 1, "recon_loss_sums": 0}
# one grad_accum=2 notebook G+D step: two generator forwards a microbatch (pass 1
# without a graph, pass 2 with), one backward a microbatch in pass 2
ACCUM_LAUNCHES = {"bn_act_dropout": 48, "bn_act_dropout_bwd": 24, "reparam_kl": 4,
                  "reparam_kl_bwd": 2, "recon_loss_sums": 2}

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


def special_kl_zero(torch, fused, mu, lv, gz):
    """Row 4 without a KL cotangent (its instance that leaves e^lv out) against
    the one with a zero cotangent, bit for bit, and against the plain version
    (NaNs where it has them, the sign of each zero, the rest as
    :func:`check_close`), on copies of the inputs with, in one group of 8 in
    every 64 elements, gz = +-0 beside lv > 0 and lv < 0, lv >= 89 (e^lv
    overflows) and a NaN lv; returns a line for the log."""
    m, l, g = (t.clone() for t in (mu, lv, gz))
    flat = [t.permute(0, 2, 3, 1).reshape(-1) for t in (m, l, g)]   # NHWC views
    at = torch.arange(0, flat[0].numel() - 7, 64, device=flat[0].device)
    vals = {0: (0.0, 0.5), 1: (-0.0, 0.5), 2: (0.0, -0.5), 3: (-0.0, -0.5), 4: (1.0, 89.0),
            5: (0.0, 100.0), 6: (1.0, float("nan")), 7: (-0.0, 1e-10)}
    for j, (gv, lval) in vals.items():
        flat[2][at + j] = gv
        flat[1][at + j] = lval
    bits = torch.int32 if mu.dtype == torch.float32 else torch.int16
    none = fused.reparam_kl_backward(m, l, g, None, 77)
    zero = fused.reparam_kl_backward(m, l, g, torch.zeros((), device=mu.device), 77)
    ref = fused.reparam_kl_backward_reference(m, l, g, None, 77)
    torch.cuda.synchronize()
    if not all(torch.equal(a.view(bits), b.view(bits)) for a, b in zip(none, zero)):
        raise SystemExit("row 4: without a KL cotangent it is not bitwise the zero cotangent's")
    for name, a, r in zip(("dmu", "dlv"), none, ref):
        nan = torch.isnan(r)
        zeros = r == 0
        if not (torch.equal(nan, torch.isnan(a)) and torch.equal(
                torch.signbit(a[zeros]), torch.signbit(r[zeros]))):
            raise SystemExit(f"row 4 {name}: NaNs or signed zeros differ from the plain version")
        check_close(f"row 4 {name} (special values)", a[~nan], r[~nan], mu.dtype)
    return (f"no KL cotangent bitwise a zero one over {8 * at.numel()} special values, NaNs "
            f"and signed zeros as the plain version's")


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
                f"bytes {b[2]:.4f}, SASS issue {b[3]:.4f})")
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
                f"{b[2]:.4f}, SASS issue {b[3]:.4f}) yardstick_ms={y_ms:.4f} "
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
        zk = special_kl_zero(torch, fused, mu, lv, gz)
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
            f"{max(errs4):.3e}; {zk}; eps "
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
                f"bound_ms={b[0]:.4f} ({b[1]}; bytes {b[2]:.4f}, SASS issue {b[3]:.4f}) "
                f"grid={launch.blocks}x{launch.threads} split: {split_text(split)}")
            rot = rotation(mu, lv, gz)
            k_ms = time_cuda(torch, lambda i: fused.reparam_kl_backward(*rot[i % len(rot)], None, 77))
            p_ms = time_cuda(torch, lambda i: fused.reparam_kl_backward_reference(
                *rot[i % len(rot)], None, 77), windows=1, warmup=1)
            b = bounds(5 * n * 4, n, "reparam_bwd_kernel", dtype, kl=False)
            note("reparam_kl_bwd", k_ms, p_ms, b, max(errs4))
            log(f"row 4 f32 {shape} (gkl None, as on the step): kernel_ms={k_ms:.4f} "
                f"plain_ms={p_ms:.4f} bound_ms={b[0]:.4f} ({b[1]}; bytes {b[2]:.4f}, SASS issue "
                f"{b[3]:.4f}); {row4_grids(torch, fused, rot, 77, 0, None)}")
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
                f"plain_ms={p_ms:.4f} bound_ms={b[0]:.4f} ({b[1]}; bytes {b[2]:.4f}, SASS issue "
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
            f"{s['bytes_ms']:.4f}, SASS issue {s['instr_ms']:.4f}), plain {s['plain_ms']:.4f} ms; "
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


def critic_draws(torch, critic, batch, rng, device, forwards=("real", "fake", "interp", "gen")):
    """Injected critic Dropout2d masks for the given forwards (default: the
    two-optimizer step's four) and the GP alphas."""
    from vaegan_tpu_torch.models import ResBlockDiscriminator

    inj = {}
    for fwd in forwards:
        inj[f"d_masks_{fwd}"] = {
            f"{n}.dropout": (torch.rand((batch, m.conv1.weight_orig.shape[0], 1, 1), generator=rng)
                             >= 0.5).to(device)
            for n, m in critic.named_modules() if isinstance(m, ResBlockDiscriminator)}
    inj["alpha"] = torch.rand(batch, generator=rng).to(device)
    return inj


GRAD_MEDIAN_TOL = 1e-3     # median over a net's tensors of |g_a - g_b|_2 / |g_b|_2
GRAD_MAX_TOL = 1e-2        # max over a net's tensors of max |g_a - g_b| / max |g_net|
NET_NAMES = {"g": "generator", "d": "critic"}


def step_errors(a, b):
    """Per net ("g", "d"): (median relative L2 error of its gradient tensors,
    largest element error over the net's largest gradient), and the metrics whose
    relative error exceeds 2e-4 (+1e-5 absolute). A net ``b`` has no
    gradients for (it was not updated) is left out."""
    bad = [k for k, want in b["metrics"].items()
           if not abs(a["metrics"][k] - want) <= 1e-5 + 2e-4 * abs(want)]
    out = {}
    for net in (n for n in ("g", "d") if b["grads"].get(n)):
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
    nets = "; ".join(f"{NET_NAMES[n]} gradients median rel L2 err {m:.3e}, max err / max "
                     f"grad {w:.3e}" for n, (m, w) in errs.items())
    log(f"{what}: {nets}; metrics out of tolerance {bad}; d_loss {a['metrics']['d_loss']!r} "
        f"vs {b['metrics']['d_loss']!r}, g_loss {a['metrics']['g_loss']!r} vs {b['metrics']['g_loss']!r} -> "
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
    want = STEP_LAUNCHES
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
    profile_step(torch, lambda: step(state, batches[1], next(counter)),
                 f"one batch-{TRAIN_BATCH} G step", card_line)
    return t4, t16


def profile_step(torch, fn, what, card_line):
    """One call of ``fn`` under torch.profiler: its wall time, the device-busy
    share, the top 10 device kernels, each port kernel's share, and the host
    side: the top 8 operators by self CPU time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                      for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                     reverse=True)
    busy = sum(k[0] for k in kernels)
    if busy == 0:
        log("profiler: no device time recorded")
        return wall_ms, None
    covered = device_busy_ms(prof, DeviceType)
    log(f"profile of {what}: wall {wall_ms:.3f} ms (profiler on), device busy {covered:.3f} ms "
        f"({100 * covered / wall_ms:.1f}%: the union of the kernels' intervals; their times "
        f"summed {busy:.3f} ms) [{card_line}]")
    for ms, count, name in kernels[:10]:
        log(f"  {ms:9.3f} ms  x{count:<4d} {name[:110]}")
    for tag, pattern in (("bn_act_dropout", "bn_act_dropout_fwd"),
                         ("bn_act_dropout_bwd", "bn_act_dropout_bwd"),
                         ("reparam_kl", "reparam_fwd"), ("reparam_kl_bwd", "reparam_bwd"),
                         ("recon_loss_sums", "recon_sums")):
        ms = sum(k[0] for k in kernels if pattern in k[2])
        log(f"  {tag}: {ms:.4f} ms of the device time ({100 * ms / busy:.2f}%)")
    host = sorted(((e.self_cpu_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                   if e.self_cpu_time_total > 0), reverse=True)
    log(f"  host: {sum(h[0] for h in host):.3f} ms of self CPU time over {sum(h[1] for h in host)} "
        "operator calls; the top 8:")
    for ms, count, name in host[:8]:
        log(f"  {ms:9.3f} ms  x{count:<5d} {name[:100]}")
    return wall_ms, covered


def device_busy_ms(prof, device_type):
    """Milliseconds in which at least one kernel ran: the union of the device
    events' intervals (a sum would count overlapping kernels twice)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == device_type.CUDA and e.time_range.end > e.time_range.start)
    total, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


LOOP_IMAGES = 32          # 8 batches of 4 an epoch
NIFTI_FILES, NIFTI_SIDE = 16, 300


def loop_config(vt, tmp, **train):
    """The notebook preset at full width with ``use_pallas="all"``, fed 32
    synthetic "texture" images from an ``hbm_cache`` loader, with phase 8's
    cadences (a grid, a checkpoint and a flush every 4 steps, the NaN guard on)
    and its folders under ``tmp``."""
    cfg = vt.preset("notebook")
    return cfg.replace(
        data=cfg.data.replace(synthetic=True, synthetic_size=LOOP_IMAGES,
                              synthetic_style="texture", batch_size=TRAIN_BATCH, hbm_cache=True),
        train=cfg.train.replace(**{
            "use_pallas": "all", "n_epochs": 2, "sample_interval": 4, "checkpoint_every": 4,
            "log_every": 4, "nan_check": True, "sample_dir": os.path.join(tmp, "samples"),
            "checkpoint_dir": os.path.join(tmp, "ck"), **train}))


def launch_logger(fused, metrics_logger):
    """A MetricsLogger that also notes, at each step's ``log``, the kernel launches
    since the previous step's (the sampler's before a grid step, then the step's)."""

    class LaunchLogger(metrics_logger):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.per_step, self._last = [], dict(fused.LAUNCHES)

        def log(self, *a):
            now = dict(fused.LAUNCHES)
            self.per_step.append({k: now[k] - self._last[k] for k in now})
            self._last = now
            super().log(*a)

    return LaunchLogger


def state_tree(torch, state):
    """Copies of everything a train state carries, for bitwise comparison."""
    def clone(t):
        if isinstance(t, torch.Tensor):
            return t.detach().clone()
        if isinstance(t, dict):
            return {k: clone(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [clone(v) for v in t]
        return t

    return clone({"generator": state.generator.state_dict(), "critic": state.critic.state_dict(),
                  "opt_g": state.opt_g.state_dict(), "opt_d": state.opt_d.state_dict(),
                  "step": state.step, "g_metrics": state.g_metrics, "g_ema": state.g_ema})


def tree_diff(torch, a, b, path=""):
    """The paths at which two :func:`state_tree` copies differ (bit for bit; a
    restored optimizer keeps its step counts on the state's device, the
    original on the CPU, so values are compared wherever each lies)."""
    if isinstance(a, torch.Tensor):
        return [] if isinstance(b, torch.Tensor) and torch.equal(a, b.to(a.device)) else [path]
    if isinstance(a, dict):
        if set(a) != set(b):
            return [path]
        return [d for k in a for d in tree_diff(torch, a[k], b[k], f"{path}.{k}")]
    if isinstance(a, list):
        if len(a) != len(b):
            return [path]
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in tree_diff(torch, x, y, f"{path}[{i}]")]
    return [] if a == b else [path]


def metrics_close(a, b, rel=2e-4, atol=1e-5):
    """Keys of metric dicts ``a`` / ``b`` that differ by more than ``rel`` of |b| + ``atol``."""
    return sorted(k for k in b if not abs(a[k] - b[k]) <= atol + rel * abs(b[k]))


def phase_feed(torch, vt, cfg, tmp, card_line):
    """Phase 8.1: the loop's feeds give the same batches; the NIfTI decoders agree."""
    import numpy as np

    from vaegan_tpu_torch.data import nifti, pipeline
    from vaegan_tpu_torch.ops import _build

    want = [b.clone() for b in pipeline.make_loader(cfg.data, seed=cfg.train.seed, device="cuda")]
    for lag in (0, 2_000_000):
        # lag: a ~1 ms sleep kernel on the consumer's stream before each read, so
        # the host runs ahead and frees batches the card has not read yet (the
        # allocator must not hand their memory to the next copies)
        host_loader = pipeline.make_loader(cfg.data.replace(hbm_cache=False), seed=cfg.train.seed)
        got = []
        for b in pipeline.device_prefetch(iter(host_loader), "cuda", depth=2):
            if lag:
                torch.cuda._sleep(lag)
            got.append(b.clone())
        torch.cuda.synchronize()
        same = len(got) == len(want) == LOOP_IMAGES // TRAIN_BATCH and all(
            torch.equal(a, b) for a, b in zip(got, want))
        log(f"feed: one epoch of the hbm_cache loader vs DataLoader + device_prefetch(depth=2)"
            f"{' with the consumer lagging' if lag else ''}: {len(got)} batches of "
            f"{tuple(want[0].shape)}, bitwise equal={same}")
        if not same:
            raise SystemExit("the host feed's batches differ from the hbm_cache loader's")

    t0 = time.perf_counter()
    try:
        lib = _build.build_host()
    except (OSError, RuntimeError) as e:
        raise SystemExit(f"the native NIfTI decoder did not build:\n{e}")
    log(f"native NIfTI decoder built from {os.path.relpath(_build.HOST_SOURCE, HERE)} in "
        f"{time.perf_counter() - t0:.2f} s: {os.path.relpath(lib, HERE)}")
    d = os.path.join(tmp, "nii")
    os.makedirs(d)
    rng = np.random.default_rng(SEED)
    for i in range(NIFTI_FILES):
        img = rng.normal(size=(NIFTI_SIDE, NIFTI_SIDE)).astype(np.float32) * 100 + 50
        nifti.write_nifti(os.path.join(d, f"hand_{i:03d}.nii" + (".gz" if i % 2 else "")), img)
    ds = pipeline.NiftiDataset(d, cfg.data.image_size, num_workers=cfg.data.num_workers)
    if not nifti.have_native():
        raise SystemExit(f"the native NIfTI decoder did not load: {nifti.native_error()}")
    t0 = time.perf_counter()
    native = ds.load_batch(range(NIFTI_FILES))
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    python = np.stack([nifti.load_image(os.path.join(d, f), cfg.data.image_size, use_native=False)
                       for f in ds.filenames])
    t_python = time.perf_counter() - t0
    err = float(np.abs(native - python).max())
    log(f"NIfTI: {NIFTI_FILES} files {NIFTI_SIDE}x{NIFTI_SIDE} (half gzipped) -> "
        f"{cfg.data.image_size}x{cfg.data.image_size}: native batch decode {t_native * 1e3:.1f} ms, "
        f"Python decoder {t_python * 1e3:.1f} ms, max_abs_err {err:.3e} (tolerance 1e-6) "
        f"[{card_line}]")
    if not err <= 1e-6:
        raise SystemExit("the native and Python NIfTI decoders disagree")
    cached = pipeline.CachedDataset(ds, cache_path=os.path.join(tmp, "nii_cache.npy"))
    feed = pipeline.DataLoader(cached, batch_size=TRAIN_BATCH, shuffle=False, prefetch_batches=2)
    got = list(pipeline.device_prefetch(iter(feed), "cuda", depth=2))
    ok = len(got) == NIFTI_FILES // TRAIN_BATCH and all(
        torch.equal(b.cpu(), torch.from_numpy(native[i * TRAIN_BATCH:(i + 1) * TRAIN_BATCH]))
        for i, b in enumerate(got))
    log(f"CachedDataset: one epoch of {len(got)} batches through device_prefetch equals the "
        f"native decode bitwise={ok}")
    if not ok:
        raise SystemExit("the cached NIfTI epoch differs from its decode")


def phase_loop(torch, vt, card_line, t4):
    """Phase 8: the notebook training loop on the card through ``vt.train``."""
    import shutil
    import warnings

    from vaegan_tpu_torch.checkpoint import CheckpointManager
    from vaegan_tpu_torch.data import pipeline
    from vaegan_tpu_torch.ops import fused
    from vaegan_tpu_torch.train import loop
    from vaegan_tpu_torch.utils.metrics import MetricsLogger, StdoutSink

    tmp = tempfile.mkdtemp(prefix="vaegan_loop_")
    last = [time.perf_counter()]

    def lap() -> str:
        """Seconds since the previous lap: where phase 8's time goes."""
        now = time.perf_counter()
        out, last[0] = f"({now - last[0]:.1f} s)", now
        return out

    try:
        cfg = loop_config(vt, tmp)
        log(f"== phase 8: training loop, preset('notebook') {cfg.data.image_size}x"
            f"{cfg.data.image_size} batch {TRAIN_BATCH} float32, use_pallas='all', "
            f"{LOOP_IMAGES} synthetic 'texture' images, 2 epochs, a grid / checkpoint / flush "
            "every 4 steps, NaN guard on ==")
        phase_feed(torch, vt, cfg, tmp, card_line)
        log(f"feeds checked {lap()}")

        # ---- the main path: vt.train(cfg), counts from 0 just before, read just after
        steps = cfg.train.n_epochs * LOOP_IMAGES // TRAIN_BATCH
        torch.cuda.synchronize()
        fused.reset_launches()
        logger = launch_logger(fused, MetricsLogger)(sinks=[StdoutSink()],
                                                     flush_every=cfg.train.log_every)
        state, logger = vt.train(cfg, logger=logger)
        torch.cuda.synchronize()
        loop_launches = dict(fused.LAUNCHES)
        history = [m for m in logger.history if "_wall_s" not in m]
        grids = sorted(os.listdir(cfg.train.sample_dir), key=lambda f: int(f.split(".")[0]))
        kept = CheckpointManager(cfg.train.checkpoint_dir).all_steps()
        bad_steps = []
        for i, got in enumerate(logger.per_step):
            want = dict(STEP_LAUNCHES[True])
            if i % cfg.train.sample_interval == 0:
                want = {k: v + SAMPLER_LAUNCHES[k] for k, v in want.items()}
            if got != want:
                bad_steps.append((i, got, want))
        finite = all(v == v and abs(v) != float("inf") for m in history for v in m.values())
        log(f"loop: {state.step} steps, launches {loop_launches}; per step as phase 6's plus the "
            f"sampler's on grid steps: {not bad_steps}; metrics finite={finite}; grids {grids}; "
            f"checkpoints kept {kept}; {logger.history[-1]['_images_per_sec']:.2f} images/s over "
            f"the run with its grids and saves [{card_line}] {lap()}")
        if bad_steps or not finite or state.step != steps or len(history) != steps:
            raise SystemExit(f"loop: wrong launches {bad_steps[:2]}, a non-finite metric or a "
                             "missing step")
        if grids != [f"{i}.png" for i in range(0, steps, cfg.train.sample_interval)]:
            raise SystemExit(f"loop: grids {grids}")
        if kept != [8, 12, 16]:
            raise SystemExit(f"loop: checkpoints {kept}, want the last 3 of 4, 8, 12, 16")
        missing = [k for k, v in loop_launches.items() if v == 0]
        if missing:
            raise SystemExit(f"loop: kernels {missing} never launched on the main path")

        # ---- the sampler leaves the state as it was and replays the step's forward
        batch = next(iter(pipeline.make_loader(cfg.data, seed=SEED, device="cuda")))
        before = state_tree(torch, state)
        imgs = loop.make_sampler(cfg)(state, batch, 4321)
        changed = tree_diff(torch, state_tree(torch, state), before)
        seen = []
        hook = state.generator.register_forward_hook(lambda m, i, o: seen.append(o[0].detach()))
        vt.make_train_step(cfg, True)(state, batch, 4321)
        hook.remove()
        err, scale = float((imgs - seen[0]).abs().max()), float(seen[0].abs().max())
        log(f"sampler: state bitwise unchanged={not changed}; its images vs the step's gen_imgs "
            f"max_abs_err {err:.3e}, max|ref| {scale:.3e}, tolerance {1e-4 * scale:.3e} "
            f"(cuDNN's run-to-run order, as phase 3) {lap()}")
        if changed or not err <= 1e-4 * scale:
            raise SystemExit(f"sampler: changed {changed[:4]} or images out of tolerance")
        del state, before
        torch.cuda.empty_cache()

        # ---- resume: stopped at 8 and resumed to 16, against the uninterrupted run.
        # With cuDNN's default algorithms two runs of this loop part after a few
        # steps (run-to-run rounding, amplified by the game from random weights at
        # full width; the figure against the main run is printed), so both runs
        # here take cuDNN's deterministic algorithms: then an exact resume gives
        # the uninterrupted run's losses bit for bit
        flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        try:
            ucfg = loop_config(vt, tmp, checkpoint_dir=None,
                               sample_dir=os.path.join(tmp, "samples_whole"))
            _, ulog = vt.train(ucfg, logger=MetricsLogger(sinks=[], flush_every=4))
            rcfg = loop_config(vt, tmp, checkpoint_dir=os.path.join(tmp, "ck_resume"),
                               checkpoint_every=steps // 2,
                               sample_dir=os.path.join(tmp, "samples_resume"))
            vt.train(rcfg.replace(train=rcfg.train.replace(max_steps=steps // 2)),
                     logger=MetricsLogger(sinks=[], flush_every=4))
            resumed, rlog = vt.train(rcfg, resume=True,
                                     logger=MetricsLogger(sinks=[], flush_every=4))
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
        whole = [m for m in ulog.history if "_wall_s" not in m][steps // 2:]
        rhist = [m for m in rlog.history if "_wall_s" not in m]
        off = {i + steps // 2 + 1: metrics_close(m, ref) for i, (m, ref) in enumerate(zip(rhist, whole))}

        def worst(got, ref):
            return max(abs(m[k] - r[k]) / (1e-5 + 2e-4 * abs(r[k]))
                       for m, r in zip(got, ref) for k in r)

        log(f"resume (cudnn.deterministic): stopped at step {steps // 2}, resumed to "
            f"{resumed.step}: {len(rhist)} steps run; losses of steps {steps // 2 + 1}-{steps} "
            f"against the uninterrupted run: bitwise equal={rhist == whole}, largest difference "
            f"{worst(rhist, whole):.3f} of the tolerance, 2e-4 relative + 1e-5 a metric (phase 6's "
            f"run-to-run figure for one step). For scale, the uninterrupted deterministic run "
            f"against the main run (default algorithms) over the same steps: "
            f"{worst(whole, history[steps // 2:]):.3e} of it {lap()}")
        if resumed.step != steps or len(rhist) != steps // 2 or any(off.values()):
            raise SystemExit(f"resume: out of tolerance at {[(s, k) for s, k in off.items() if k]}")
        mgr = CheckpointManager(rcfg.train.checkpoint_dir)
        template = vt.create_train_state(rcfg, device="cuda", seed=SEED + 1)
        t0 = time.perf_counter()
        mgr.save(resumed, force=True)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        mgr.restore(template)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        diff = tree_diff(torch, state_tree(torch, template), state_tree(torch, resumed))
        size = os.path.getsize(os.path.join(rcfg.train.checkpoint_dir, f"{resumed.step}.pt"))
        log(f"checkpoint round trip (step {mgr.latest_step()}, parameters, BN and spectral "
            f"buffers, both RMSprop states, G metrics): bitwise equal={not diff}; "
            f"{size / 2 ** 30:.2f} GiB, save {t_save:.2f} s, restore {t_restore:.2f} s [{card_line}] "
            f"{lap()}")
        if diff:
            raise SystemExit(f"the restored state differs at {diff[:4]}")
        del template
        torch.cuda.empty_cache()

        # ---- numbers (no claim): loop images/s, device busy share, syncs per step
        quiet = dict(sample_interval=cfg.train.sample_interval, checkpoint_dir=None,
                     nan_check=False)
        dev_loader = pipeline.make_loader(cfg.data, seed=SEED, device="cuda")
        rates = {}
        for feed in ("hbm_cache", "host"):
            fcfg = loop_config(vt, tmp, max_steps=8, **quiet)
            if feed == "host":
                fcfg = fcfg.replace(data=fcfg.data.replace(hbm_cache=False))
            _, flog = vt.train(fcfg, loader=dev_loader if feed == "hbm_cache" else None,
                               state=resumed, logger=MetricsLogger(sinks=[], flush_every=4))
            rates[feed] = flog.history[-1]["_images_per_sec"]
        log(f"loop images/s at batch {TRAIN_BATCH} (8 steps, a grid and a flush every 4): "
            f"hbm_cache {rates['hbm_cache']:.2f}, host feed {rates['host']:.2f}; the bare step "
            f"(phase 7) {TRAIN_BATCH / t4:.2f}; loop overhead over the step "
            f"{(TRAIN_BATCH / rates['hbm_cache'] - t4) * 1e3:.1f} ms a step (hbm_cache) "
            f"[{card_line}] {lap()}")

        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        pcfg = loop_config(vt, tmp, max_steps=4, **quiet)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            vt.train(pcfg, loader=dev_loader, state=resumed,
                     logger=MetricsLogger(sinks=[], flush_every=4))
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / 1e3
        log(f"profiled loop window of 4 steps (one grid): wall {wall_ms:.3f} ms (profiler on), "
            f"device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%) [{card_line}] {lap()}")

        # "setup": switching the mode on and off (a warning of its own is counted there)
        where, syncs = ["setup"], {"setup": 0, "loop": 0, "flush": 0}

        class PhaseLogger(MetricsLogger):
            def flush(self):
                where[0] = "flush"
                try:
                    super().flush()
                finally:
                    where[0] = "loop"

        sites, texts = set(), {}

        def note(message, *a, **k):
            if "synchroniz" in str(message):
                syncs[where[0]] += 1
                texts.setdefault(where[0], str(message)[:120])
                if where[0] == "loop":   # the innermost frames that led to it
                    frames = [f for f in traceback.extract_stack()[:-1]
                              if "warnings" not in os.path.basename(f.filename)][-3:]
                    sites.add(" <- ".join(f"{os.path.basename(f.filename)}:{f.lineno} ({f.line})"
                                          for f in reversed(frames)))

        scfg = loop_config(vt, tmp, max_steps=8, log_every=8, sample_interval=0,
                           checkpoint_dir=None, nan_check=False)
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = note
            torch.cuda.set_sync_debug_mode("warn")
            try:
                where[0] = "loop"
                vt.train(scfg, loader=dev_loader, state=resumed,
                         logger=PhaseLogger(sinks=[], flush_every=8))
            finally:
                where[0] = "setup"
                torch.cuda.set_sync_debug_mode(0)
        log(f"host syncs over 8 loop steps (torch.cuda.set_sync_debug_mode('warn'), no grids, "
            f"no saves, one flush): {syncs['loop']} outside the flush "
            f"({syncs['loop'] / 8:.2f} a step) at {sorted(sites)}, {syncs['flush']} in it, "
            f"{syncs['setup']} from switching the mode on; first warning of each: {texts} "
            f"[{card_line}] {lap()}")
        del resumed, dev_loader
        torch.cuda.empty_cache()
        return loop_launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 9: the Larsen three-optimizer step and gradient accumulation
# ---------------------------------------------------------------------------

CRITIC_SLOPE = 0.2
PAPER_STEPS = 6
PAPER_LOOP_IMAGES = 16    # 4 batches of 4 an epoch


def paper_config(vt, mode="all"):
    """The ``vaegan_paper`` preset uncut (96², batch 4, float32, the notebook
    critic, BCE, Dis_l, gamma 100, EMA 0.999, KL mean) with ``use_pallas``."""
    cfg = vt.preset("vaegan_paper")
    return cfg.replace(train=cfg.train.replace(use_pallas=mode))


def critic_sites(torch, critic, size):
    """(C, H, W) of every fused BN of a critic forward, in launch order: the
    stem's bn1, then each block's bn1 (its input) and bn2 (its conv1 output)."""
    from vaegan_tpu_torch.models import ResBlockDiscriminator

    mods = [critic.bn1] + [bn for m in critic.modules() if isinstance(m, ResBlockDiscriminator)
                           for bn in (m.bn1, m.bn2)]
    shapes = []
    hooks = [m.register_forward_hook(lambda mod, inp, out: shapes.append(tuple(inp[0].shape[1:])))
             for m in mods]
    dev = next(critic.parameters()).device
    with torch.inference_mode():
        critic(torch.zeros(1, size, size, 1, device=dev), train=False)
    for h in hooks:
        h.remove()
    return shapes


def phase_critic_kernels(torch, sites, bounds, batch=TRAIN_BATCH, phase="9.1"):
    """Rows 1-2 at the critic's fused sites (slope 0.2, p = 0) over ``batch``
    images, bitwise against their plain versions, timed beside their bounds."""
    from vaegan_tpu_torch.ops import fused

    log(f"== phase {phase}: rows 1-2 at the critic's {len(sites)} fused BN sites (vaegan_paper, "
        f"batch {batch}, slope {CRITIC_SLOPE}, p = 0, f32; timing and tolerances as phase 5) ==")
    big = torch.randn(4096, 4096, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(9))
    busy = lambda: big @ big  # noqa: E731
    g = torch.Generator(device="cuda").manual_seed(SEED + 9)
    cl = lambda t: t.contiguous(memory_format=torch.channels_last)  # noqa: E731
    out = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bytes_ms": 0.0, "instr_ms": 0.0,
               "bound_by": "bytes", "max_abs_err": 0.0, "sites": len(sites)}
           for k in ("bn_act_dropout", "bn_act_dropout_bwd")}

    def note(name, k_ms, p_ms, b, err):
        o = out[name]
        for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("bound_ms", b[0]), ("bytes_ms", b[2]),
                       ("instr_ms", b[3])):
            o[key] += v
        if b[1] != "bytes":
            o["bound_by"] = "operations"
        o["max_abs_err"] = max(o["max_abs_err"], err)

    for i, (c, h, w) in enumerate(sites):
        mean = torch.randn(c, device="cuda", generator=g) * 0.3
        var = torch.rand(c, device="cuda", generator=g) + 0.5
        scale = torch.rand(c, device="cuda", generator=g) + 0.5
        bias = torch.randn(c, device="cuda", generator=g) * 0.1
        x = cl(torch.randn(batch, c, h, w, device="cuda", generator=g))
        gy = cl(torch.randn(batch, c, h, w, device="cuda", generator=g))
        args = (mean, var, scale, bias, 0, CRITIC_SLOPE, 0.0)
        n = x.numel()
        # row 1
        y = fused.bn_act_dropout_forward(x, *args)
        r = fused.bn_act_dropout_reference(x, *args)
        torch.cuda.synchronize()
        if not torch.equal(y, r):
            raise SystemExit(f"critic site {i}: row 1's y is not bitwise the plain version's")
        rot = rotation(x)
        k1 = time_cuda(torch, lambda j: fused.bn_act_dropout_forward(rot[j % len(rot)][0], *args))
        p1 = time_cuda(torch, lambda j: fused.bn_act_dropout_reference(rot[j % len(rot)][0], *args),
                       windows=1, warmup=1)
        b1 = bounds(2 * n * 4 + 4 * c * 4, n, "bn_act_dropout_fwd_kernel", torch.float32, None,
                    False)
        note("bn_act_dropout", k1, p1, b1, 0.0)
        # row 2
        k = fused.bn_act_dropout_backward(x, gy, *args)
        r = fused.bn_act_dropout_backward_reference(x, gy, *args)
        torch.cuda.synchronize()
        if not torch.equal(k[0], r[0]):
            raise SystemExit(f"critic site {i}: row 2's dx is not bitwise the plain version's")
        err = max(check_close(f"critic site {i} {name}", k[j], r[j], torch.float32, True)
                  for j, name in enumerate(("dscale", "dbias", "dmean", "dvar"), 1))
        det = twenty_runs(torch, lambda: fused.bn_act_dropout_backward(x, gy, *args), k, busy)
        if not det:
            raise SystemExit(f"critic site {i}: row 2's {RUNS} runs are not bitwise equal")
        rot = rotation(x, gy)
        call = lambda j: fused.bn_act_dropout_backward(*rot[j % len(rot)], *args)  # noqa: E731
        k2 = time_cuda(torch, call)
        split = profile_split(torch, call)
        one_kernel(f"critic site {i} row 2", split)
        p2 = time_cuda(torch, lambda j: fused.bn_act_dropout_backward_reference(
            *rot[j % len(rot)], *args), windows=1, warmup=1)
        launch = fused.bwd_launch_for(x, 0.0)
        b2 = bounds(3 * n * 4 + 8 * c * 4, n, "bn_act_dropout_bwd_kernel", torch.float32,
                    launch.vec, False)
        note("bn_act_dropout_bwd", k2, p2, b2, err)
        log(f"critic site {i} C={c:3d} HxW={h}x{w}: row 1 y bitwise equal, kernel_ms={k1:.4f} "
            f"plain_ms={p1:.4f} bound_ms={b1[0]:.4f} ({b1[1]}; bytes {b1[2]:.4f}, SASS issue "
            f"{b1[3]:.4f}); row 2 dx bitwise equal, sums max_abs_err={err:.3e}, "
            f"deterministic_x{RUNS}=True, kernel_ms={k2:.4f} plain_ms={p2:.4f} "
            f"bound_ms={b2[0]:.4f} ({b2[1]}; bytes {b2[2]:.4f}, SASS issue {b2[3]:.4f}) "
            f"grid={launch.blocks}x{launch.threads} split: {split_text(split)}")
        del x, gy, y, r, k, rot
    torch.cuda.empty_cache()
    for name, row in (("1", "bn_act_dropout"), ("2", "bn_act_dropout_bwd")):
        o = out[row]
        log(f"row {name} over the critic's {len(sites)} sites (one forward; f32, p = 0): kernel "
            f"{o['ms']:.4f} ms, bound {o['bound_ms']:.4f} ms ({o['bound_by']}; bytes "
            f"{o['bytes_ms']:.4f}, SASS issue {o['instr_ms']:.4f}; "
            f"{100 * o['bound_ms'] / o['ms']:.1f}% of the bound reached), plain "
            f"{o['plain_ms']:.4f} ms")
    return out


def converge_spectral(torch, critic, iterations=1000):
    """Advance each spectral layer's (u, v) to its weight's top singular pair."""
    from vaegan_tpu_torch.models.layers import Conv2D
    from vaegan_tpu_torch.ops.spectral_norm import spectral_normalize

    with torch.no_grad():
        for m in critic.modules():
            if isinstance(m, Conv2D) and m.spectral:
                _, u, v = spectral_normalize(m.weight_orig, m.weight_u, m.weight_v, update=True,
                                             n_iterations=iterations)
                m.weight_u.copy_(u)
                m.weight_v.copy_(v)


def copy_state(torch, vt, cfg, state):
    """A fresh train state for ``cfg`` holding a copy of ``state``."""
    import copy

    st = vt.create_train_state(cfg, device=next(state.generator.parameters()).device, seed=SEED)
    st.generator.load_state_dict(state.generator.state_dict())
    st.critic.load_state_dict(state.critic.state_dict())
    # a loaded optimizer state shares the given tensors: copy them
    st.opt_g.load_state_dict(copy.deepcopy(state.opt_g.state_dict()))
    st.opt_d.load_state_dict(copy.deepcopy(state.opt_d.state_dict()))
    return st


def phase_accum(torch, vt):
    """``grad_accum=2`` of each scheme at full width: on duplicated microbatches
    at dropout 0 against the full-batch step, then the notebook's accumulating
    step at its own dropout with its launches counted (the "accum" path)."""
    from vaegan_tpu_torch.ops import fused

    log("== phase 9.4: gradient accumulation (grad_accum=2, batch 4 = 2 x 2): each scheme at full "
        "width, dropout 0, on concat(x, x) with its draws duplicated, against the full-batch "
        "step from the same seeded state with its spectral (u, v) converged (each "
        "microbatch's critic forwards run their own power iterations). The notebook's critic "
        "updates between the two passes, and a moved W would leave pass 2's second "
        "microbatch one power iteration further than the full step's G half: so one full "
        "step first (it clamps the fresh weights), then the compared steps at lr_d = 0. "
        "Tolerances: metrics 2e-3 relative + 1e-5 (tests/test_train_step.py:265-276); the "
        "gradients each optimizer is stepped with, phase 6's ==")
    for name in ("vaegan_paper", "notebook"):
        cfg = vt.preset(name)
        cfg = cfg.replace(generator=cfg.generator.replace(dropout_prob=0.0),
                          discriminator=cfg.discriminator.replace(dropout_prob=0.0),
                          train=cfg.train.replace(use_pallas="all"))
        paper = name == "vaegan_paper"
        make = ((lambda c, inject=None: vt.make_paper_train_step(c, inject=inject)) if paper else
                (lambda c, inject=None: vt.make_train_step(c, True, inject=inject)))
        size = cfg.data.image_size
        g = torch.Generator(device="cuda").manual_seed(SEED + 4)
        state = vt.create_train_state(cfg, device="cuda", seed=SEED)
        if not paper:
            state, _ = make(cfg)(state, torch.rand((TRAIN_BATCH, size, size, 1), device="cuda",
                                                   generator=g), 30)
            cfg = cfg.replace(optim=cfg.optim.replace(lr_d=0.0))
        converge_spectral(torch, state.critic)
        x = torch.rand((2, size, size, 1), device="cuda", generator=g)
        lat = (2,) + tuple(vt.latent_shape(cfg))
        inj = {"eps": torch.randn(lat, device="cuda", generator=g)}
        if paper:
            inj["z_p"] = torch.randn(lat, device="cuda", generator=g)
        else:
            inj["alpha"] = torch.rand(2, device="cuda", generator=g)
        inj = {k: torch.cat([v, v]) for k, v in inj.items()}
        recs = []
        for c in (cfg, cfg.replace(train=cfg.train.replace(grad_accum=2))):
            st = copy_state(torch, vt, cfg, state)
            grads = record_grads(st)
            _, m = make(c, inject=inj)(st, torch.cat([x, x]), 9)
            torch.cuda.synchronize()
            recs.append({"metrics": {k: float(v) for k, v in m.items()},
                         "grads": {k: {n: t.cpu() for n, t in v.items()} for k, v in grads.items()}})
            del st, grads
        full, acc = recs
        bad = [k for k, want in full["metrics"].items()
               if not abs(acc["metrics"][k] - want) <= 1e-5 + 2e-3 * abs(want)]
        errs, _ = step_errors(acc, full)
        ok = not bad and all(m <= GRAD_MEDIAN_TOL and w <= GRAD_MAX_TOL for m, w in errs.values())
        log(f"{name} grad_accum=2 vs the full batch: metrics out of tolerance {bad}; generator "
            f"gradients median rel L2 err {errs['g'][0]:.3e}, max err / max grad {errs['g'][1]:.3e}; "
            f"critic {errs['d'][0]:.3e}, {errs['d'][1]:.3e}; d_loss {acc['metrics']['d_loss']!r} vs "
            f"{full['metrics']['d_loss']!r}, g_loss {acc['metrics']['g_loss']!r} vs "
            f"{full['metrics']['g_loss']!r} -> {'agree' if ok else 'DISAGREE'}")
        if not ok:
            raise SystemExit(f"{name}: the accumulating step disagrees with the full-batch step")
        del recs, state
        torch.cuda.empty_cache()

    # the accum path: the notebook's accumulating G+D step as a user builds it
    cfg = vt.preset("notebook")
    cfg = cfg.replace(train=cfg.train.replace(use_pallas="all", grad_accum=2))
    state = vt.create_train_state(cfg, device="cuda", seed=SEED)
    xb = torch.rand((TRAIN_BATCH, cfg.data.image_size, cfg.data.image_size, 1), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(SEED + 5))
    step = vt.make_train_step(cfg, True)
    torch.cuda.synchronize()
    fused.reset_launches()
    state, m = step(state, xb, 11)
    torch.cuda.synchronize()
    accum_launches = dict(fused.LAUNCHES)
    finite = all(v == v and abs(v) != float("inf") for v in (float(t) for t in m.values()))
    log(f"accum path: one notebook grad_accum=2 G+D step (dropout 0.5, 256², batch 4 = 2 x 2): "
        f"launches {accum_launches} (want {ACCUM_LAUNCHES}), finite={finite}")
    if accum_launches != ACCUM_LAUNCHES or not finite:
        raise SystemExit("accum path: wrong launch counts or a non-finite loss")
    del state
    torch.cuda.empty_cache()
    return accum_launches


def phase_paper(torch, vt, bounds, card_line, tf32_defaults):
    """Phase 9: the Larsen step of ``vaegan_paper`` at full width."""
    import shutil

    from vaegan_tpu_torch.checkpoint import CheckpointManager
    from vaegan_tpu_torch.ops import fused
    from vaegan_tpu_torch.train import paper_draws
    from vaegan_tpu_torch.utils.metrics import MetricsLogger

    cfg_all, cfg_off = paper_config(vt), paper_config(vt, "off")
    size = cfg_all.data.image_size
    o, lc = cfg_all.optim, cfg_all.loss
    log(f"== phase 9: the Larsen three-optimizer step, preset('vaegan_paper') {size}x{size} batch "
        f"{TRAIN_BATCH} float32 ({lc.adversarial}, {lc.reconstruction}, gamma {o.gamma}, "
        f"{o.optimizer}, EMA {cfg_all.train.ema_decay}, KL {lc.kl_reduction}), use_pallas='all', "
        "seeded weights, synthetic batches ==")
    state = vt.create_train_state(cfg_all, device="cuda", seed=SEED)
    n_g = sum(p.numel() for p in state.generator.parameters())
    n_d = sum(p.numel() for p in state.critic.parameters())
    log(f"generator {n_g} parameters, critic {n_d} parameters (critic fused: "
        f"{state.critic.use_pallas}, no gradient penalty)")
    if not state.critic.use_pallas:
        raise SystemExit("the paper step's critic is not fused")
    sites = critic_sites(torch, state.critic, size)
    critic_kernels = phase_critic_kernels(torch, sites, bounds)

    log("== phase 9.2: six paper steps with exact launch counts, fused vs unfused ==")
    data = torch.Generator(device="cuda").manual_seed(SEED + 2)
    batches = [torch.rand((TRAIN_BATCH, size, size, 1), device="cuda", generator=data)
               for _ in range(3)]
    step = vt.make_paper_train_step(cfg_all)
    for i in range(PAPER_STEPS):
        before = dict(fused.LAUNCHES)
        state, m = step(state, batches[i % 3], 2000 + i)
        torch.cuda.synchronize()
        got = {k: fused.LAUNCHES[k] - before[k] for k in before}
        vals = {k: float(v) for k, v in m.items()}
        finite = all(v == v and abs(v) != float("inf") for v in vals.values())
        log(f"paper step {i}: launches {got}, finite={finite}, "
            + ", ".join(f"{k}={v:.6g}" for k, v in vals.items()))
        if got != PAPER_LAUNCHES or not finite:
            raise SystemExit(f"paper step {i}: launch counts {got} (want {PAPER_LAUNCHES}) or a "
                             "non-finite loss")

    def one_step(cfg_, x, inject):
        st = vt.create_train_state(cfg_, device="cuda", seed=SEED)
        grads = record_grads(st)
        stp = vt.make_paper_train_step(cfg_, inject=inject)
        st, m = stp(st, x, 7)
        torch.cuda.synchronize()
        rec = {"metrics": {k: float(v) for k, v in m.items()},
               "grads": {k: {n: t.cpu() for n, t in v.items()} for k, v in grads.items()},
               "draws": paper_draws(stp, st.generator) if cfg_.train.use_pallas == "all" else None}
        del st
        return rec

    # the paper critic's real and x_p masks (x~ shares the real forward's), a prior sample
    rng = torch.Generator().manual_seed(12)
    inj = critic_draws(torch, state.critic, TRAIN_BATCH, rng, "cuda", ("real", "prior"))
    inj["z_p"] = torch.randn((TRAIN_BATCH,) + tuple(vt.latent_shape(cfg_all)), generator=rng).cuda()
    for flags in ("TF32 off", "default"):
        if flags == "TF32 off":
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        else:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32_defaults
        fused_rec = one_step(cfg_all, batches[0], inj)
        if set(fused_rec["draws"]) != {"g_masks", "g_masks_p", "eps"}:
            raise SystemExit(f"the fused paper step's draws: {sorted(fused_rec['draws'])}")
        off_rec = one_step(cfg_off, batches[0], {**inj, **fused_rec["draws"]})
        if not compare_steps(f"fused vs use_pallas='off' paper step, the masks of both generator "
                             f"forwards and the critic's injected ({flags} flags)",
                             fused_rec, off_rec):
            raise SystemExit("the fused paper step disagrees with the unfused one")
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32_defaults

    log(f"== phase 9.3: paper step numbers on {card_line} (float32, PyTorch's default flags) ==")
    counter = iter(range(10 ** 6))
    t_step = time_host(torch, lambda: step(state, batches[0], next(counter)), reps=10, warmup=3)
    log(f"paper step batch {TRAIN_BATCH}: {t_step * 1e3:.3f} ms median of 10 after 3 warm-up, "
        f"{TRAIN_BATCH / t_step:.2f} images/s [{card_line}]")
    profile_step(torch, lambda: step(state, batches[1], next(counter)),
                 f"one batch-{TRAIN_BATCH} paper step", card_line)
    del state, step
    torch.cuda.empty_cache()

    # ---- the paper path: vt.train of the preset, stopped at step 4 and resumed to
    # 6, counts from 0 just before the first run and read after the second
    tmp = tempfile.mkdtemp(prefix="vaegan_paper_")
    try:
        def loop_cfg(max_steps):
            return cfg_all.replace(
                data=cfg_all.data.replace(synthetic=True, synthetic_size=PAPER_LOOP_IMAGES,
                                          synthetic_style="texture", batch_size=TRAIN_BATCH,
                                          hbm_cache=True),
                train=cfg_all.train.replace(
                    n_epochs=2, max_steps=max_steps, sample_interval=2, checkpoint_every=2,
                    log_every=2, nan_check=True, sample_dir=os.path.join(tmp, "samples"),
                    checkpoint_dir=os.path.join(tmp, "ck")))

        torch.cuda.synchronize()
        fused.reset_launches()
        per_step, history = [], []
        t0 = time.perf_counter()
        for max_steps, resume in ((4, False), (PAPER_STEPS, True)):
            logger = launch_logger(fused, MetricsLogger)(sinks=[], flush_every=2)
            state, logger = vt.train(loop_cfg(max_steps), logger=logger, resume=resume)
            per_step += logger.per_step
            history += [m for m in logger.history if "_wall_s" not in m]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        paper_launches = dict(fused.LAUNCHES)
        grids = sorted(os.listdir(os.path.join(tmp, "samples")), key=lambda f: int(f.split(".")[0]))
        kept = CheckpointManager(os.path.join(tmp, "ck")).all_steps()
        want = [{k: v + (SAMPLER_LAUNCHES[k] if i % 2 == 0 else 0) for k, v in PAPER_LAUNCHES.items()}
                for i in range(PAPER_STEPS)]
        finite = all(v == v and abs(v) != float("inf") for m in history for v in m.values())
        log(f"paper path: vt.train(preset('vaegan_paper')) on {PAPER_LOOP_IMAGES} synthetic images, "
            f"stopped at step 4 and resumed to {state.step}: launches {paper_launches}; per step "
            f"the step's plus the sampler's on grid steps: {per_step == want}; metrics finite="
            f"{finite}; grids {grids}; checkpoints kept {kept}; {wall:.1f} s with its grids and "
            f"saves [{card_line}]")
        if (per_step != want or not finite or state.step != PAPER_STEPS
                or len(history) != PAPER_STEPS):
            raise SystemExit(f"paper path: launches {per_step[:2]} (want {want[:2]}), a non-finite "
                             "metric or a missing step")
        if grids != ["0.png", "2.png", "4.png"] or kept != [2, 4, 6]:
            raise SystemExit(f"paper path: grids {grids}, checkpoints {kept}")
        missing = [k for k, v in paper_launches.items() if v == 0 and PAPER_LAUNCHES[k]]
        if missing:
            raise SystemExit(f"paper path: kernels {missing} never launched")
        del state
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    accum_launches = phase_accum(torch, vt)
    return {"critic": critic_kernels, "paper": paper_launches, "accum": accum_launches,
            "step_s": t_step, "sites": sites}


# ---------------------------------------------------------------------------
# phase 10: concat / concat3 critic batching and the single-card surface
# ---------------------------------------------------------------------------

# one vaegan_paper step under critic_batching="concat": the critic's 7 sites run
# once, over cat(real, x~, x_p). Forwards 12 + 6 + 7; backwards: encoder 7 + 6 +
# 6, decoder 7 + 6 + 6 (x~ and x_p), critic 7
PAPER_CONCAT_LAUNCHES = {"bn_act_dropout": 25, "bn_act_dropout_bwd": 45, "reparam_kl": 1,
                         "reparam_kl_bwd": 1, "recon_loss_sums": 0}
CONCAT_PLAN = (True, True, False, True)     # G+D, G+D, critic only, G+D
# the CLI's train of the notebook preset (n_critics 1, a grid every 20 batches):
# four G+D steps and the sampler's forward before step 0
CLI_STEPS = 4
CLI_TRAIN_LAUNCHES = {k: CLI_STEPS * v + SAMPLER_LAUNCHES[k]
                      for k, v in STEP_LAUNCHES[True].items()}
# the bench's step counts cut for time (its knobs' defaults otherwise)
BENCH_STEPS = {"": "40", "--paper": "5", "--vae": "5", "--loop": "40", "--infer": "10",
               "--loader": "20"}
# runs the CLI in a fresh process and prints the kernel launches it made
# the launches line is one write on a line of its own, after the rest of the
# output: torchrun's processes share one pipe, and two buffered prints once
# ran together on one line
CLI_COUNTING = ("import json, os, sys\n"
                "import torch\n"
                "from vaegan_tpu_torch import cli\n"
                "from vaegan_tpu_torch.ops import fused\n"
                "fused.reset_launches()\n"
                "rc = cli.main(sys.argv[1:])\n"
                "torch.cuda.synchronize()\n"
                "sys.stdout.flush()\n"
                "os.write(1, ('\\nlaunches ' + json.dumps(dict(fused.LAUNCHES)) + '\\n').encode())\n"
                "sys.exit(rc)\n")


def concat_config(vt, name, batching, mode="all"):
    """Preset ``name`` uncut with ``critic_batching`` and ``use_pallas``."""
    cfg = vt.preset(name)
    return cfg.replace(train=cfg.train.replace(critic_batching=batching, use_pallas=mode))


def counted_steps(torch, fused, what, step_of, state, batches, want_of, seed):
    """Run ``step_of(i)`` on each batch, each step's launches held to
    ``want_of(i)``; returns the state and the path's launches (counts set to 0
    just before the first step)."""
    torch.cuda.synchronize()
    fused.reset_launches()
    for i, x in enumerate(batches):
        before = dict(fused.LAUNCHES)
        state, m = step_of(i)(state, x, seed + i)
        torch.cuda.synchronize()
        got = {k: fused.LAUNCHES[k] - before[k] for k in before}
        vals = {k: float(v) for k, v in m.items()}
        finite = all(v == v and abs(v) != float("inf") for v in vals.values())
        log(f"{what} step {i}: launches {got}, finite={finite}, "
            + ", ".join(f"{k}={v:.6g}" for k, v in vals.items()))
        if got != want_of(i) or not finite:
            raise SystemExit(f"{what} step {i}: launches {got} (want {want_of(i)}) or a "
                             "non-finite loss")
    return state, dict(fused.LAUNCHES)


def phase_concat(torch, vt, bounds, card_line, sites):
    """Phase 10.1: ``concat`` / ``concat3`` at full width on the card."""
    from vaegan_tpu_torch.ops import fused
    from vaegan_tpu_torch.train import paper_draws

    size = vt.preset("notebook").data.image_size
    log(f"== phase 10.1: critic batching, preset('notebook') {size}x{size} batch {TRAIN_BATCH} "
        "float32 use_pallas='all' (the critic unfused under the penalty), four steps each "
        "(G+D, G+D, critic only, G+D) with exact launch counts, then step ms (median of 5 G+D "
        "steps after 1) and peak memory beside 'separate' ==")
    data = torch.Generator(device="cuda").manual_seed(SEED + 10)
    batches = [torch.rand((TRAIN_BATCH, size, size, 1), device="cuda", generator=data)
               for _ in range(len(CONCAT_PLAN))]
    paths, numbers = {}, {}
    for batching in ("separate", "concat", "concat3"):
        cfg = concat_config(vt, "notebook", batching)
        state = vt.create_train_state(cfg, device="cuda", seed=SEED)
        steps = {g: vt.make_train_step(cfg, g) for g in (True, False)}
        torch.cuda.reset_peak_memory_stats()
        state, paths[batching] = counted_steps(
            torch, fused, f"notebook {batching}", lambda i: steps[CONCAT_PLAN[i]], state, batches,
            lambda i: STEP_LAUNCHES[CONCAT_PLAN[i]], 3000)
        counter = iter(range(10 ** 6))
        t = time_host(torch, lambda: steps[True](state, batches[0], 3100 + next(counter)),
                      reps=5, warmup=1)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        numbers[batching] = (t, peak)
        log(f"notebook {batching}: G+D step {t * 1e3:.3f} ms median of 5 "
            f"({TRAIN_BATCH / t:.2f} images/s), peak device memory {peak:.2f} GiB; path launches "
            f"{paths[batching]} [{card_line}]")
        del state, steps
        torch.cuda.empty_cache()
    for batching in ("concat", "concat3"):
        t, peak = numbers[batching]
        log(f"notebook {batching} against separate: step {t * 1e3:.3f} vs "
            f"{numbers['separate'][0] * 1e3:.3f} ms ({t / numbers['separate'][0]:.3f}x), peak "
            f"{peak:.2f} vs {numbers['separate'][1]:.2f} GiB [{card_line}]")

    # ---- the paper step under concat: the critic fused, one forward over batch 12
    cfg_all = concat_config(vt, "vaegan_paper", "concat")
    cfg_off = concat_config(vt, "vaegan_paper", "concat", "off")
    psize = cfg_all.data.image_size
    log(f"== phase 10.1: preset('vaegan_paper') {psize}x{psize} batch {TRAIN_BATCH} with "
        "critic_batching='concat': four steps with exact launch counts (one critic forward "
        f"over batch {3 * TRAIN_BATCH}, critic fused) ==")
    state = vt.create_train_state(cfg_all, device="cuda", seed=SEED)
    if not state.critic.use_pallas:
        raise SystemExit("the concat paper step's critic is not fused")
    step = vt.make_paper_train_step(cfg_all)
    pbatches = [torch.rand((TRAIN_BATCH, psize, psize, 1), device="cuda", generator=data)
                for _ in range(4)]
    state, paths["paper_concat"] = counted_steps(
        torch, fused, "paper concat", lambda i: step, state, pbatches,
        lambda i: PAPER_CONCAT_LAUNCHES, 4000)
    counter = iter(range(10 ** 6))
    t_paper = time_host(torch, lambda: step(state, pbatches[0], 4100 + next(counter)), reps=5,
                        warmup=1)
    log(f"paper concat step batch {TRAIN_BATCH}: {t_paper * 1e3:.3f} ms median of 5 "
        f"({TRAIN_BATCH / t_paper:.2f} images/s) [{card_line}]")
    del state, step
    torch.cuda.empty_cache()
    critic = phase_critic_kernels(torch, sites, bounds, batch=3 * TRAIN_BATCH, phase="10.1")

    # ---- fused against unfused concat paper step, the generator draws replayed
    def one_step(cfg_, inject):
        st = vt.create_train_state(cfg_, device="cuda", seed=SEED)
        grads = record_grads(st)
        stp = vt.make_paper_train_step(cfg_, inject=inject)
        st, m = stp(st, pbatches[0], 7)
        torch.cuda.synchronize()
        rec = {"metrics": {k: float(v) for k, v in m.items()},
               "grads": {k: {n: t.cpu() for n, t in v.items()} for k, v in grads.items()},
               "draws": paper_draws(stp, st.generator) if cfg_.train.use_pallas == "all" else None}
        del st
        return rec

    z_p = torch.randn((TRAIN_BATCH,) + tuple(vt.latent_shape(cfg_all)),
                      generator=torch.Generator().manual_seed(13)).to("cuda")
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    fused_rec = one_step(cfg_all, {"z_p": z_p})
    off_rec = one_step(cfg_off, {"z_p": z_p, **fused_rec["draws"]})
    if not compare_steps("fused vs use_pallas='off' concat paper step, the masks of both "
                         "generator forwards injected, the critic's one forward drawing from "
                         "the same stream (TF32 off)", fused_rec, off_rec):
        raise SystemExit("the fused concat paper step disagrees with the unfused one")
    torch.cuda.empty_cache()
    return {"paths": paths, "critic": critic, "numbers": numbers, "paper_s": t_paper}


def run_together(commands, cwd=HERE, timeout=900):
    """``(label, argv)`` or ``(label, argv, cwd)`` processes, all started
    together (two threads of the CPU each, the checkout on ``PYTHONPATH``).
    Exits on a non-zero return code (after every process has ended). Returns
    each one's stdout."""
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(argv, cwd=own[0] if own else cwd, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _, argv, *own in commands]
    outs, failed = [], []
    try:
        for (label, *_), proc in zip(commands, procs):
            out, err = proc.communicate(timeout=timeout)
            lines = out.strip().splitlines()
            log(f"{label}: rc {proc.returncode} after {time.perf_counter() - t0:.1f} s; "
                f"{lines[-1][:300] if lines else '(no output)'}")
            if proc.returncode != 0:
                log(out[-3000:])
                log(err[-3000:])
                failed.append(label)
            outs.append(out)
    finally:
        for proc in procs:          # none outlives the phase, whatever happened
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise SystemExit(f"{failed} exited non-zero")
    return outs


def run_cli(commands, cwd, timeout=900):
    """CLI commands, each in its own process and all started together: each is
    ``(args, counting)``, run as ``python -m vaegan_tpu_torch.cli args`` or, when
    counting, through the wrapper that prints the kernel launches
    (:func:`run_together`)."""
    return run_together([(f"cli {args[0]}", ([sys.executable, "-c", CLI_COUNTING] if counting
                                              else [sys.executable, "-m", "vaegan_tpu_torch.cli"])
                          + args) for args, counting in commands], cwd, timeout)


def phase_cli(torch, vt, card_line):
    """Phase 10.2: every model subcommand of the CLI on the card, each in its
    own process; the commands that do not depend on each other run at once."""
    import shutil

    log("== phase 10.2: the CLI (python -m vaegan_tpu_torch.cli), each command in its own "
        "process, on the card; independent commands started together (times are since "
        "their group started) ==")
    tmp = tempfile.mkdtemp(prefix="vaegan_cli_")
    try:
        p = lambda *a: os.path.join(tmp, *a)  # noqa: E731
        (out,) = run_cli([(["print-config", "--preset", "notebook"], False)], tmp)
        cfg = json.loads(out)
        cfg["train"]["use_pallas"] = "all"
        cfg["train"]["sample_dir"] = p("samples")
        with open(p("cfg.json"), "w") as f:
            json.dump(cfg, f)
        common = ["--config", p("cfg.json"), "--synthetic", "--checkpoint", p("ck")]
        out, _ = run_cli([
            (["train", *common, "--max-steps", str(CLI_STEPS), "--metrics-jsonl",
              p("m.jsonl")], True),
            (["search", "--preset", "notebook", "--synthetic", "--image-size", "64",
              "--trials", "1", "--max-steps-per-trial", "2", "--results", p("r", "params.json"),
              "--archive", p("r", "archive")], False)], tmp)
        launches = json.loads(out.strip().splitlines()[-1].split(" ", 1)[1])
        metrics = [json.loads(x) for x in open(p("m.jsonl"))]
        finite = all(v == v and abs(v) != float("inf") for m in metrics for v in m.values())
        log(f"cli train (notebook, 256², batch 4, use_pallas all, {CLI_STEPS} steps): launches "
            f"{launches} (want {CLI_TRAIN_LAUNCHES}), {len(metrics)} metric lines, finite={finite}")
        if launches != CLI_TRAIN_LAUNCHES or len(metrics) != CLI_STEPS or not finite:
            raise SystemExit("cli train: wrong launch counts or metrics")
        with open(p("r", "params.json")) as f:
            registry = json.load(f)
        log(f"cli search (64², 1 trial of 2 steps): registry {[e['status'] for e in registry]}, "
            f"mse {[e.get('recon_mse') for e in registry]}")
        if [e["status"] for e in registry] != ["ok"]:
            raise SystemExit(f"cli search: registry {registry}")
        evaluated = run_cli([
            (["eval", *common], False),
            (["sample", *common, "-n", "25", "-o", p("s.png")], False),
            (["interpolate", *common, "-o", p("i.png")], False),
            (["export", *common, "--generator-out", p("g.pt"), "--discriminator-out", p("d.pt")],
             False),
            (["export-serving", *common, "--out", p("bundle")], False)], tmp)[0]
        if "Mean squared error" not in evaluated:
            raise SystemExit("cli eval printed no MSE")
        run_cli([(["import", "--config", p("cfg.json"), "--checkpoint", p("ck2"),
                   "--generator", p("g.pt"), "--discriminator", p("d.pt")], False)], tmp)
        a, b = (torch.load(os.path.join(d, f"{vt.CheckpointManager(d).latest_step()}.pt"),
                           map_location="cpu", weights_only=True) for d in (p("ck"), p("ck2")))
        same = {net: a[net].keys() == b[net].keys()
                and all(torch.equal(a[net][k], b[net][k]) for k in a[net])
                for net in ("generator", "critic")}
        log(f"cli export then import: step {a['step']} -> {b['step']}, state_dicts bitwise "
            f"equal {same}")
        if not all(same.values()) or b["step"] != 0:
            raise SystemExit("cli export/import does not round-trip bitwise")
        bundle = vt.load_bundle(p("bundle"), device="cuda")
        x = torch.rand((2, 256, 256, 1), device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(5))
        recon, mse = bundle.reconstruct(x)
        finite = bool(torch.isfinite(recon).all()) and float(mse) == float(mse)
        log(f"load_bundle of the exported bundle: reconstruct {tuple(recon.shape)}, mse "
            f"{float(mse)!r}, finite={finite}")
        if not finite or tuple(recon.shape) != (2, 256, 256, 1):
            raise SystemExit("the CLI's serving bundle does not reconstruct")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_bench(torch, vt, card_line):
    """Phase 10.3: each mode of the port's bench once, and ``entry()``."""
    from vaegan_tpu_torch import bench
    from vaegan_tpu_torch.entry import entry
    from vaegan_tpu_torch.ops import fused

    log(f"== phase 10.3: python -m vaegan_tpu_torch.bench, each mode at its knobs' defaults "
        f"with BENCH_STEPS cut to {BENCH_STEPS} (a headline or loop run times whole 40-step "
        "cycles whatever BENCH_STEPS asks) ==")
    out = {}
    for mode, steps in BENCH_STEPS.items():
        os.environ["BENCH_STEPS"] = steps
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = bench.main(([mode] if mode else []) + ["--device", "cuda"])
        lines = [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]
        for rec in lines:
            log(json.dumps(rec) + f" [{card_line}]")
        log(f"bench {mode or '(default)'}: rc {rc}, {time.perf_counter() - t0:.1f} s")
        if rc != 0 or not lines or not all(r["value"] > 0 for r in lines):
            raise SystemExit(f"bench {mode}: rc {rc}, lines {lines}")
        out[mode or "step"] = lines
        torch.cuda.empty_cache()
    del os.environ["BENCH_STEPS"]

    forward, (gen, x) = entry()
    torch.cuda.synchronize()
    fused.reset_launches()
    y = forward(gen, x)
    torch.cuda.synchronize()
    launches = dict(fused.LAUNCHES)
    finite = bool(torch.isfinite(y).all())
    log(f"entry(): forward {tuple(x.shape)} -> {tuple(y.shape)}, finite={finite}, launches "
        f"{launches}")
    if not finite or tuple(y.shape) != tuple(x.shape) or launches["bn_act_dropout"] != 12:
        raise SystemExit("entry(): wrong output or launches")
    return out


# ---------------------------------------------------------------------------
# phase 11: data-parallel training (vaegan_256_dp) and recomputation
# ---------------------------------------------------------------------------

# one vaegan_256_dp step with remat on: a G+D step's generator forward runs its
# 12 fused sites again in the backward (the recompute of each block); a
# critic-only step's generator forward records no graph, so nothing reruns
DP_STEP_LAUNCHES = {
    True: {"bn_act_dropout": 24, "bn_act_dropout_bwd": 12, "reparam_kl": 1,
           "reparam_kl_bwd": 1, "recon_loss_sums": 1},
    False: STEP_LAUNCHES[False]}
DP_BATCHES = (64, 32, 16)   # the preset's global batch, then the cuts tried if it does not fit
DP_RANK_BATCH = 8           # the global batch of the two gloo ranks on one card
REMAT_BATCH = 16            # remat on against off
DP_CLI_STEPS = 2


def dp_config(vt, tmp, batch, **train):
    """``vaegan_256_dp`` at full width (256², the notebook generator and
    critic, bfloat16, EMA 0.999) with ``use_pallas="all"`` (the preset's
    default is "off") and ``remat`` on, global batch ``batch``, two batches of
    synthetic "texture" images an epoch, two epochs, ``n_critics`` 2 (so that
    critic-only steps run), a grid, a checkpoint and a flush every 2 steps, the
    NaN guard on, folders under ``tmp``."""
    cfg = vt.preset("vaegan_256_dp")
    return cfg.replace(
        data=cfg.data.replace(synthetic=True, synthetic_size=2 * batch,
                              synthetic_style="texture", batch_size=batch),
        train=cfg.train.replace(**{
            "use_pallas": "all", "remat": True, "n_critics": 2, "n_epochs": 2,
            "sample_interval": 2, "checkpoint_every": 2, "log_every": 2, "nan_check": True,
            "sample_dir": os.path.join(tmp, "samples"),
            "checkpoint_dir": os.path.join(tmp, "ck"), **train}))


def dp_step_launches(do_g, grid):
    """A DP loop step's launches: the step's, plus the sampler's on a grid step."""
    want = dict(DP_STEP_LAUNCHES[do_g])
    if grid:
        want = {k: v + SAMPLER_LAUNCHES[k] for k, v in want.items()}
    return want


DP_PLAN = ((True, True), (False, False), (True, True), (False, False))   # (G+D, grid) a step


def dp_loop(torch, vt, cfg, mesh, fused, logger_class, device="cuda"):
    """Phase 11.1's runs of ``train_data_parallel``: 2 steps that save a
    checkpoint at step 2, a resume to step 2 (restores and runs nothing; its
    state must equal the first run's bit for bit), a resume to step 4. Returns
    the last state, each step's launches (from ``logger_class``, a
    :func:`launch_logger`), the flushed metrics and the restore's differing
    paths."""
    from vaegan_tpu_torch.parallel.train import train_data_parallel

    def run(max_steps, resume):
        logger = logger_class(flush_every=cfg.train.log_every)
        c = cfg.replace(train=cfg.train.replace(max_steps=max_steps))
        return train_data_parallel(c, logger=logger, resume=resume, mesh=mesh, device=device)

    state, logger_a = run(2, False)
    saved = state_tree(torch, state)
    restored, _ = run(2, True)
    diff = tree_diff(torch, state_tree(torch, restored), saved)
    del restored, saved
    state, logger_c = run(4, True)
    history = [m for lg in (logger_a, logger_c) for m in lg.history if "_wall_s" not in m]
    return state, logger_a.per_step + logger_c.per_step, history, diff


def fit_batch(torch, vt, mesh, tmp):
    """The largest of ``DP_BATCHES`` whose remat G+D step fits on the card (one
    step each, largest first), with that step's peak memory."""
    for batch in DP_BATCHES:
        cfg = dp_config(vt, tmp, batch)
        try:
            state = vt.create_train_state(cfg, device="cuda", seed=SEED)
            step = vt.parallel.make_parallel_train_step(cfg, mesh, True)
            x = torch.rand((batch, 256, 256, 1), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(SEED))
            torch.cuda.reset_peak_memory_stats()
            step(state, x, 1)
            torch.cuda.synchronize()
            return batch, torch.cuda.max_memory_allocated() / 2 ** 30
        except torch.cuda.OutOfMemoryError as e:
            log(f"vaegan_256_dp at global batch {batch} with remat does not fit on the card "
                f"({str(e).splitlines()[0][:300]}); trying the next cut")
        finally:
            state = step = x = None
            torch.cuda.empty_cache()
    raise SystemExit(f"vaegan_256_dp fits at none of the global batches {DP_BATCHES}")


def site_notes(out):
    """``note(name, kernel ms, plain ms, bound, err)``: adds a site's figures to
    ``out[name]`` (a phase's summary of a row over its sites)."""
    def note(name, k_ms, p_ms, b, err):
        o = out[name]
        o["ms"] += k_ms
        o["plain_ms"] += p_ms
        o["bound_ms"] += b[0]
        o["issue_ms"] += b[3]
        o["bound_by"] = "operations" if b[1] != "bytes" else o["bound_by"]
        o["max_abs_err"] = max(o["max_abs_err"], err)
        o["sites"] += 1
    return note


def row4_grids(torch, fused, rot, seed, base, stripe):
    """Row 4 without a KL cotangent on two other grids than the wrapper's: one
    resident wave and SMs x 8 blocks; ms on the rotated inputs ``rot``, as text
    (a build with no such launch says so)."""
    launch = getattr(fused, "_launch_reparam_bwd", None)
    if launch is None:
        return "no other grid to time in this build"
    mu = rot[0][0]
    big_l, big_g = stripe or (mu.numel(), mu.numel())
    grids = {"one resident wave": fused._reparam_bwd_wave(mu, big_l != big_g),
             "SMs x 8": 8 * fused._sms(mu.device)}
    ms = {k: time_cuda(torch, lambda j, b=b: launch(*rot[j % len(rot)], None, seed, base, big_l,
                                                     big_g, b))
          for k, b in grids.items()}
    return ", ".join(f"on {k} ({grids[k]} blocks) {v:.4f} ms" for k, v in ms.items()) + (
        f" (the wrapper's grid: {fused.reparam_bwd_blocks(mu)} blocks)")


def phase_dp_kernels(torch, sites, latent, bounds, batch):
    """Phase 11.3: rows 1-4 with a non-zero index base at the DP path's
    generator sites (bfloat16, the local batch): each call's base is the one
    rank 1 of a two-process mesh at this local batch passes (its first
    element's global index), and the kernel is held bitwise to its plain
    version with the same base."""
    from vaegan_tpu_torch.ops import fused

    log(f"== phase 11.3: rows 1-4 with an index base, at the 12 generator sites of a "
        f"vaegan_256_dp step (bfloat16, batch {batch}; base = batch x C x H x W, rank 1 of "
        "two at this batch) bitwise against their plain versions with the same base; kernel: "
        "median of 5 CUDA-event windows of 20 launches, inputs rotated through >= 256 MB; "
        "plain: one window of 2 ==")
    g = torch.Generator(device="cuda").manual_seed(SEED + 11)
    cl = lambda t: t.contiguous(memory_format=torch.channels_last)  # noqa: E731
    bf16 = torch.bfloat16
    out = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": "bytes",
               "issue_ms": 0.0, "max_abs_err": 0.0, "sites": 0, "dtype": "bfloat16",
               "batch": batch}
           for k in ("bn_act_dropout", "bn_act_dropout_bwd", "reparam_kl", "reparam_kl_bwd")}
    note = site_notes(out)

    for i, (c, h, w) in enumerate(sites):
        p = 0.5 if i % 2 == 0 else 0.0          # bn1 drops at 0.5, bn2 at 0
        mean = torch.randn(c, device="cuda", generator=g) * 0.3
        var = torch.rand(c, device="cuda", generator=g) + 0.5
        scale = torch.rand(c, device="cuda", generator=g) + 0.5
        bias = torch.randn(c, device="cuda", generator=g) * 0.1
        x = cl(torch.randn(batch, c, h, w, device="cuda", generator=g).to(bf16))
        gy = cl(torch.randn(batch, c, h, w, device="cuda", generator=g).to(bf16))
        n, seed = x.numel(), 6100 + i
        args = (mean, var, scale, bias, seed, SLOPE, p, 1e-5, n)
        y = fused.bn_act_dropout_forward(x, *args)
        r = fused.bn_act_dropout_reference(x, *args)
        moved = p == 0 or not torch.equal(y, fused.bn_act_dropout_forward(x, *args[:-1], 0))
        k = fused.bn_act_dropout_backward(x, gy, *args)
        kr = fused.bn_act_dropout_backward_reference(x, gy, *args)
        torch.cuda.synchronize()
        if not (torch.equal(y, r) and torch.equal(k[0], kr[0]) and moved):
            raise SystemExit(f"row 1/2 site {i} with base {n}: y or dx is not bitwise the plain "
                             f"version's, or the base did not move the mask ({moved})")
        err = max(check_close(f"row 2 site {i} {nm}", k[j], kr[j], bf16, True)
                  for j, nm in enumerate(("dscale", "dbias", "dmean", "dvar"), 1))
        rot = rotation(x, gy)
        k1 = time_cuda(torch, lambda j: fused.bn_act_dropout_forward(rot[j % len(rot)][0], *args))
        p1 = time_cuda(torch, lambda j: fused.bn_act_dropout_reference(rot[j % len(rot)][0],
                                                                       *args),
                       reps=2, windows=1, warmup=1)
        b1 = bounds(2 * n * 2 + 4 * c * 4, n, "bn_act_dropout_fwd_kernel", bf16, None, p > 0)
        note("bn_act_dropout", k1, p1, b1, 0.0)
        k2 = time_cuda(torch, lambda j: fused.bn_act_dropout_backward(*rot[j % len(rot)], *args))
        p2 = time_cuda(torch, lambda j: fused.bn_act_dropout_backward_reference(
            *rot[j % len(rot)], *args), reps=2, windows=1, warmup=1)
        launch = fused.bwd_launch_for(x, p)
        b2 = bounds(3 * n * 2 + 8 * c * 4, n, "bn_act_dropout_bwd_kernel", bf16, launch.vec,
                    p > 0)
        note("bn_act_dropout_bwd", k2, p2, b2, err)
        log(f"site {i:2d} C={c:3d} HxW={h}x{w} p={p} base={n}: y and dx bitwise equal, sums "
            f"max_abs_err={err:.3e}; row 1 kernel_ms={k1:.4f} plain_ms={p1:.4f} "
            f"bound_ms={b1[0]:.4f} ({b1[1]}); row 2 kernel_ms={k2:.4f} plain_ms={p2:.4f} "
            f"bound_ms={b2[0]:.4f} ({b2[1]})")
        del x, gy, y, r, k, kr, rot
        torch.cuda.empty_cache()

    h, w, c = latent
    mu = cl(torch.randn((batch, c, h, w), device="cuda", generator=g)).to(bf16)
    lv = cl(torch.randn((batch, c, h, w), device="cuda", generator=g) * 0.5).to(bf16)
    gz = cl(torch.randn((batch, c, h, w), device="cuda", generator=g)).to(bf16)
    n = mu.numel()
    z, kl = fused.reparam_kl_forward(mu, lv, 88, n)
    zr, klr = fused.reparam_kl_reference(mu, lv, 88, n)
    d = fused.reparam_kl_backward(mu, lv, gz, None, 88, n)
    dr = fused.reparam_kl_backward_reference(mu, lv, gz, None, 88, n)
    moved = not torch.equal(z, fused.reparam_kl_forward(mu, lv, 88, 0)[0])
    torch.cuda.synchronize()
    if not (torch.equal(z, zr) and all(torch.equal(a, b) for a, b in zip(d, dr)) and moved):
        raise SystemExit(f"rows 3/4 with base {n}: z, dmu or dlv is not bitwise the plain "
                         f"version's, or the base did not move the noise ({moved})")
    err3 = check_close("row 3 kl", kl, klr, bf16, True)
    rot = rotation(mu, lv, gz)
    k3 = time_cuda(torch, lambda j: fused.reparam_kl_forward(*rot[j % len(rot)][:2], 88, n))
    p3 = time_cuda(torch, lambda j: fused.reparam_kl_reference(*rot[j % len(rot)][:2], 88, n),
                   reps=2, windows=1, warmup=1)
    b3 = bounds(3 * n * 2 + 4, n, "reparam_fwd_kernel", bf16)
    note("reparam_kl", k3, p3, b3, err3)
    k4 = time_cuda(torch, lambda j: fused.reparam_kl_backward(*rot[j % len(rot)], None, 88, n))
    p4 = time_cuda(torch, lambda j: fused.reparam_kl_backward_reference(*rot[j % len(rot)], None,
                                                                        88, n),
                   reps=2, windows=1, warmup=1)
    b4 = bounds(5 * n * 2, n, "reparam_bwd_kernel", bf16, kl=False)
    note("reparam_kl_bwd", k4, p4, b4, 0.0)
    grids = row4_grids(torch, fused, rot, 88, n, None)
    log(f"rows 3/4 {(batch, c, h, w)} base={n}: z, dmu, dlv bitwise equal, kl {float(kl)!r} vs "
        f"plain {float(klr)!r}; row 3 kernel_ms={k3:.4f} plain_ms={p3:.4f} bound_ms={b3[0]:.4f} "
        f"({b3[1]}); row 4 kernel_ms={k4:.4f} plain_ms={p4:.4f} bound_ms={b4[0]:.4f} ({b4[1]}; "
        f"SASS issue {b4[3]:.4f}); {grids}")
    for name, o in out.items():
        log(f"{name} with the index base over {o['sites']} site(s) of the DP step: kernel "
            f"{o['ms']:.4f} ms, plain {o['plain_ms']:.4f} ms, bound {o['bound_ms']:.4f} ms "
            f"({o['bound_by']}; SASS issue {o['issue_ms']:.4f} ms)")
    del mu, lv, gz, z, zr, d, dr, rot
    torch.cuda.empty_cache()
    return out


def dp_rank(rank, world, store, out):
    """One of the two gloo processes of phase 11.4 (run as ``python -c "import
    chip_smoke; chip_smoke.dp_rank(...)"``): :func:`dp_pair_steps` on this
    rank's rows, its results saved to ``out``."""
    import torch

    import vaegan_tpu_torch as vt
    from vaegan_tpu_torch.parallel import dist

    dist.initialize(backend="gloo", init_method=f"file://{store}", world_size=world, rank=rank,
                    device="cuda:0", timeout_s=600)
    try:
        res = dp_pair_steps(torch, vt, vt.parallel.make_mesh())
        torch.save(res, out)
    finally:
        dist.shutdown()


def timed_collectives(torch, vt, spent):
    """Add to ``spent[kind]`` the host seconds of every
    ``torch.distributed.all_reduce`` (the card synchronised before and after),
    by kind: ``"halo"`` and ``"gather"`` for the sums of zero-padded parts that
    ``Replica.halo`` and ``Replica.gather`` make, forward and backward (a
    cotangent has the shape its forward's sum had, which the wrapped methods
    note down), ``"sum"`` for every other. Returns a function that undoes the
    patches."""
    import torch.distributed as td

    Replica = vt.ops.replica.Replica
    inner_reduce, inner_gather, inner_halo = td.all_reduce, Replica.gather, Replica.halo
    kinds, halo = {}, []

    def gather(self, t, dim):
        shape = list(t.shape)
        shape[dim] *= self.num_model
        kinds.setdefault((tuple(shape), t.dtype), "halo" if halo else "gather")
        return inner_gather(self, t, dim)

    def halo_(self, x, top, bottom):
        halo.append(1)
        try:
            return inner_halo(self, x, top, bottom)
        finally:
            halo.pop()

    def all_reduce(t, *a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = inner_reduce(t, *a, **k)
        torch.cuda.synchronize()
        kind = kinds.get((tuple(t.shape), t.dtype), "sum")
        spent[kind] = spent.get(kind, 0.0) + time.perf_counter() - t0
        return res

    def undo():
        td.all_reduce, Replica.gather, Replica.halo = inner_reduce, inner_gather, inner_halo

    td.all_reduce, Replica.gather, Replica.halo = all_reduce, gather, halo_
    return undo


def dp_pair_steps(torch, vt, mesh, forced=None, spatial=False, tp=False):
    """Two steps (G+D, then critic only) of ``vaegan_256_dp`` in float32 at
    global batch :data:`DP_RANK_BATCH` on this process's part of the global
    batch (its rows, and its H stripe when ``spatial``; the critic head split
    over the model axis when ``tp``: ``parallel.shard_state``), cuDNN
    deterministic and TF32 off. Returns the metrics and the BN running
    statistics after each step, the host seconds spent in collectives a step
    (in all, and by kind: halo, gather, sum; :func:`timed_collectives`), a
    checksum of each parameter
    and, on data row 0 alone (the others are compared by checksum), the
    gradients each optimizer was stepped with at each step and the final
    state of both networks and of the EMA.

    ``forced`` (the one-rank reference of phase 11.4) holds, for each step,
    the two-rank run's gradients by optimizer: each optimizer records its own
    gradients, then steps with those in their place, so that every step of
    the reference starts from the two-rank run's weights and optimizer
    state."""
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dp_config(vt, tempfile.gettempdir(), DP_RANK_BATCH, dtype="float32")
    place = vt.parallel.shard_state if tp else vt.parallel.replicate_state
    state = place(vt.create_train_state(cfg, device="cuda", seed=SEED), mesh)
    spec = vt.parallel.BatchSpec(spatial=spatial)
    data = torch.Generator().manual_seed(SEED + 12)
    spent = {}
    step_with = {}
    if forced is not None:
        for key, opt, module in (("g", state.opt_g, state.generator),
                                 ("d", state.opt_d, state.critic)):
            def forcing(*a, _key=key, _named=list(module.named_parameters()), _inner=opt.step,
                        **k):
                for n, p in _named:
                    p.grad = step_with[_key][n]
                return _inner(*a, **k)

            opt.step = forcing
    grads = record_grads(state)    # outermost: the step's own gradients
    out = {"metrics": [], "allreduce_s": [], "collective_s": [], "bn": [], "grads": [],
           "step_s": []}
    undo = timed_collectives(torch, vt, spent)
    try:
        for i, do_g in enumerate((True, False)):
            batch = torch.rand((DP_RANK_BATCH, 256, 256, 1), generator=data).cuda()
            spent.clear()
            for g in grads.values():
                g.clear()
            if forced is not None:
                step_with.clear()
                step_with.update({net: {k: v.cuda() for k, v in g.items()}
                                  for net, g in forced[i].items()})
            step = vt.parallel.make_parallel_train_step(cfg, mesh, do_g, batch_spec=spec)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, vt.parallel.shard_batch(mesh, batch, spec=spec), 9000 + i)
            torch.cuda.synchronize()
            out["step_s"].append(time.perf_counter() - t0)
            out["metrics"].append({k: float(v) for k, v in m.items()})
            out["allreduce_s"].append(sum(spent.values()))
            out["collective_s"].append(dict(spent))
            out["bn"].append({f"{net}.{k}": v.cpu() for net in ("generator", "critic")
                              for k, v in getattr(state, net).state_dict().items()
                              if k.endswith(("running_mean", "running_var"))})
            if mesh.rank == 0:
                out["grads"].append({net: {k: v.cpu() for k, v in g.items()}
                                     for net, g in grads.items() if g})
    finally:
        undo()
    step_with.clear()
    out["checksums"] = {f"{net}.{k}": float(p.detach().double().sum())
                        for net in ("generator", "critic")
                        for k, p in getattr(state, net).named_parameters()}
    if mesh.rank == 0:
        out["state"] = {f"{net}.{k}": v.cpu() for net in ("generator", "critic")
                        for k, v in getattr(state, net).state_dict().items()}
        out["state"].update({f"g_ema.{k}": v.cpu() for k, v in state.g_ema.items()})
    del state, grads
    torch.cuda.empty_cache()
    return out


def held_bn(got, want):
    """Per BN statistic, its largest |diff| over its tolerance, 1e-4 of the
    tensor's largest value + 1e-5 (the card picks convolution algorithms by
    batch size: 4 rows a rank, 8 on one, so a channel whose mean cancels to
    near 0 carries the error of its terms)."""
    return {k: float((got[k] - w).abs().max()) / (1e-5 + 1e-4 * float(w.abs().max()))
            for k, w in want.items()}


def held_state(got, want):
    """Per final state tensor (BN statistics aside: :func:`held_bn`), its
    largest |diff| over the tolerance of tests/test_torch_parallel.py:
    parameters and EMA 1e-5 + 1e-4 |w| per element, spectral vectors 1e-3,
    counters exact."""
    out = {}
    for k, w in want.items():
        if k.endswith(("running_mean", "running_var")):
            continue
        if k.endswith("num_batches_tracked"):
            out[k] = 0.0 if bool((got[k] == w).all()) else float("inf")
            continue
        diff = (got[k].double() - w.double()).abs()
        tol = 1e-3 if k.endswith(("weight_u", "weight_v")) else 1e-5 + 1e-4 * w.double().abs()
        out[k] = float((diff / tol).max())
    return out


def phase_dp_ranks(torch, vt, mesh, dev, tmp, env, card_line):
    """Phase 11.4: two gloo processes on the one card, then this process's
    one-rank step forced onto their gradients step by step
    (:func:`dp_pair_steps`); returns the all-reduce seconds a step.

    Why forced: RMSprop's first update moves each weight by about 10 lr
    sign(g). Where a gradient element is at the noise level of the two runs'
    summation orders, its sign, and so the weight after the update, is noise;
    measured on an H100, the critic's BN statistics after an update then part
    from a free-running one-rank run's by 13x (after the first step) and 188x
    (after the second) their tolerance. The forced reference takes each step
    from the two-rank run's weights and optimizer state, so what the two-rank
    step computes after an update is held as tightly as before one: the
    metrics and every gradient of both steps, the BN statistics after each,
    and the final parameters, spectral vectors and EMA."""
    log(f"== phase 11.4: two gloo processes on {dev} (each its own Python process) against "
        f"this process's one-rank step, vaegan_256_dp in float32 at global batch "
        f"{DP_RANK_BATCH}, two steps (G+D, critic only), cuDNN deterministic; the one-rank "
        "step records its own gradients and then steps with the two ranks', so each of its "
        "steps starts from their state; tolerances: metrics of both steps those of "
        "tests/test_torch_parallel.py (2e-4 relative + 1e-5), gradients of both steps "
        "phase 6's, BN statistics of both networks after each step 1e-4 of each tensor's "
        "largest value + 1e-5, final parameters and EMA 1e-5 + 1e-4 |w|, spectral vectors "
        "1e-3; each parameter's checksum and every metric equal on both ranks ==")
    torch.cuda.empty_cache()
    ranks = run_ranks("11.4", 2, "dp_rank", tmp, env)
    ref = dp_pair_steps(torch, vt, mesh, forced=ranks[0]["grads"])
    torch.backends.cudnn.deterministic = False
    got = ranks[0]
    bad_m = [(i, metrics_close(m, w)) for i, (m, w) in
             enumerate(zip(got["metrics"], ref["metrics"])) if metrics_close(m, w)]
    grads_ok = all(compare_steps(
        f"two gloo ranks against one rank, step {i} ({'G+D' if i == 0 else 'critic only'})",
        {"metrics": got["metrics"][i], "grads": got["grads"][i]},
        {"metrics": ref["metrics"][i], "grads": ref["grads"][i]}) for i in range(2))
    bn_err = [held_bn(g, w) for g, w in zip(got["bn"], ref["bn"])]
    state_err = held_state(got["state"], ref["state"])
    same = ranks[0]["checksums"] == ranks[1]["checksums"] and \
        ranks[0]["metrics"] == ranks[1]["metrics"]
    bitwise = all(torch.equal(got["state"][k], w) for k, w in ref["state"].items()
                  if not k.endswith(("running_mean", "running_var")))
    for i, (m, w) in enumerate(zip(got["metrics"], ref["metrics"])):
        log(f"step {i}: two ranks " + ", ".join(f"{k}={m[k]:.7g}" for k in w)
            + "; one rank " + ", ".join(f"{k}={w[k]:.7g}" for k in w))
    worst = lambda errs, net: max(e for k, e in errs.items() if k.startswith(net))  # noqa: E731
    bad_bn = [(i, k) for i, errs in enumerate(bn_err) for k, e in errs.items() if e > 1.0]
    bad_state = [k for k, e in state_err.items() if e > 1.0]
    log(f"two gloo ranks against one rank: metrics out of tolerance {bad_m}; BN statistics "
        f"out of tolerance {bad_bn[:4]} (the largest |diff| over its tolerance: generator "
        f"{[round(worst(e, 'generator'), 3) for e in bn_err]}, critic "
        f"{[round(worst(e, 'critic'), 3) for e in bn_err]} after steps 0, 1); final state out "
        f"of tolerance {bad_state[:4]} (the largest |diff| {max(state_err.values()):.3g} of "
        f"its tolerance; parameters, spectral vectors and EMA bitwise equal {bitwise}); ranks "
        f"agree on every parameter's checksum and metric {same}; all-reduce time a step "
        f"(host clock, through gloo) {[round(s * 1e3, 3) for s in got['allreduce_s']]} ms "
        f"[{card_line}]")
    if bad_m or bad_bn or bad_state or not same or not grads_ok:
        raise SystemExit("the two-rank step disagrees with the one-rank step")
    return got["allreduce_s"]


def phase_dp(torch, vt, bounds, card_line, sites, latent):
    """Phase 11: ``vaegan_256_dp`` at full width through ``train_data_parallel``."""
    import shutil

    from vaegan_tpu_torch.checkpoint import CheckpointManager
    from vaegan_tpu_torch.ops import fused
    from vaegan_tpu_torch.parallel import dist
    from vaegan_tpu_torch.utils.metrics import MetricsLogger, StdoutSink

    tmp = tempfile.mkdtemp(prefix="vaegan_dp_")
    try:
        dev = dist.initialize(device="cuda")
        mesh = vt.parallel.make_mesh()
        log(f"== phase 11: data-parallel training, preset('vaegan_256_dp') (256², bfloat16, "
            f"EMA 0.999, the notebook generator and critic at full width) with use_pallas='all' "
            f"(the preset's default is 'off') and remat on, through train_data_parallel on a "
            f"one-process NCCL group (world {mesh.num_data}, {dev}: the degenerate mesh, no "
            "collective runs) ==")
        batch, fit_peak = fit_batch(torch, vt, mesh, tmp)
        cut = "" if batch == DP_BATCHES[0] else f" (cut from {DP_BATCHES[0]}: it did not fit)"
        log(f"global batch {batch}{cut}: one remat G+D step peaks at {fit_peak:.2f} GiB "
            f"[{card_line}]")
        cfg = dp_config(vt, tmp, batch)

        # ---- 11.1 the main path: train_data_parallel, counts from 0 just before
        # the run that saves at step 2 and read after the resumed run to step 4
        logger_class = launch_logger(fused, MetricsLogger)
        torch.cuda.synchronize()
        fused.reset_launches()
        t0 = time.perf_counter()
        state, per_step, history, diff = dp_loop(
            torch, vt, cfg, mesh, fused, lambda **kw: logger_class(sinks=[StdoutSink()], **kw))
        torch.cuda.synchronize()
        t_loop = time.perf_counter() - t0
        dp_launches = dict(fused.LAUNCHES)
        counts = {n: sum(p.numel() for p in getattr(state, n).parameters())
                  for n in ("generator", "critic")}
        log(f"parameters: {counts}")
        if counts != {"generator": 4_192_783, "critic": 139_697_217}:
            raise SystemExit("vaegan_256_dp's parameter counts are not the preset's")
        plan = DP_PLAN
        bad = [i for i, (got, (g, grid)) in enumerate(zip(per_step, plan))
               if got != dp_step_launches(g, grid)]
        for i, got in enumerate(per_step):
            log(f"dp step {i} ({'G+D' if plan[i][0] else 'critic only'}"
                f"{', grid' if plan[i][1] else ''}): launches {got}")
        finite = all(v == v and abs(v) != float("inf") for m in history for v in m.values())
        grids = sorted(os.listdir(cfg.train.sample_dir))
        kept = CheckpointManager(cfg.train.checkpoint_dir).all_steps()
        log(f"dp path: {len(per_step)} steps, launches {dp_launches}, metrics finite={finite}, "
            f"grids {grids}, checkpoints {kept}, restore of step 2 bitwise "
            f"{'equal' if not diff else 'DIFFERS at ' + str(diff[:4])}; the three runs (4 "
            f"steps, state builds and loaders included) {t_loop:.1f} s [{card_line}]")
        if (bad or len(per_step) != len(plan) or not finite or diff or kept != [2, 4]
                or grids != ["0.png", "2.png"] or not all(dp_launches.values())):
            raise SystemExit(f"dp path: wrong launches at steps {bad}, a non-finite metric, a "
                             "restore that differs, or missing grids or checkpoints")

        # step time, device-busy share; world 1 runs no collective
        step = vt.parallel.make_parallel_train_step(cfg, mesh, True)
        x = torch.rand((batch, 256, 256, 1), device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(SEED + 3))
        counter = iter(range(10 ** 6))
        torch.cuda.reset_peak_memory_stats()
        t_step = time_host(torch, lambda: step(state, x, 9100 + next(counter)), reps=3, warmup=1)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        log(f"dp G+D step at global batch {batch}, remat on: {t_step * 1e3:.3f} ms median of 3 "
            f"({batch / t_step:.2f} images/s), peak {peak:.2f} GiB [{card_line}]")
        prof = profile_step(torch, lambda: step(state, x, 9200), f"one dp G+D step b{batch}",
                            card_line)
        del state, step, x
        torch.cuda.empty_cache()

        # ---- 11.2 the price of recomputation at a batch where both fit
        remat = {}
        for on in (False, True):
            c = dp_config(vt, tmp, REMAT_BATCH, remat=on)
            st = vt.create_train_state(c, device="cuda", seed=SEED)
            stp = vt.parallel.make_parallel_train_step(c, mesh, True)
            xb = torch.rand((REMAT_BATCH, 256, 256, 1), device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(SEED + 4))
            counter = iter(range(10 ** 6))
            torch.cuda.reset_peak_memory_stats()
            t = time_host(torch, lambda: stp(st, xb, 9300 + next(counter)), reps=3, warmup=1)
            remat[on] = (t, torch.cuda.max_memory_allocated() / 2 ** 30)
            log(f"remat {'on ' if on else 'off'} at batch {REMAT_BATCH}: G+D step "
                f"{t * 1e3:.3f} ms median of 3, peak {remat[on][1]:.2f} GiB [{card_line}]")
            del st, stp, xb
            torch.cuda.empty_cache()
        log(f"remat at batch {REMAT_BATCH}: step {remat[True][0] / remat[False][0]:.3f}x the "
            f"time, peak {remat[True][1]:.2f} vs {remat[False][1]:.2f} GiB [{card_line}]")

        # ---- 11.3 rows 1-4 with an index base at the DP step's shapes
        kernels = phase_dp_kernels(torch, sites, latent, bounds, batch)

        # ---- 11.4 two gloo ranks on the one card against the one-rank step
        env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=os.pathsep.join(
            p for p in (HERE, os.environ.get("PYTHONPATH")) if p))
        allreduce_s = phase_dp_ranks(torch, vt, mesh, dev, tmp, env, card_line)

        # ---- 11.5 cli train --dp under torchrun, one process per card
        log(f"== phase 11.5: torchrun --standalone --nproc_per_node=1 -m vaegan_tpu_torch.cli "
            f"train --dp (vaegan_256_dp, use_pallas all, remat on, global batch {batch}, "
            f"{DP_CLI_STEPS} steps), launches counted ==")
        with open(os.path.join(tmp, "count.py"), "w") as f:
            f.write(CLI_COUNTING)
        c = dp_config(vt, tmp, batch, n_critics=1, n_epochs=1,
                      sample_dir=os.path.join(tmp, "cli_samples"), checkpoint_dir=None)
        with open(os.path.join(tmp, "cfg.json"), "w") as f:
            json.dump(c.to_dict(), f)
        proc = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1",
             os.path.join(tmp, "count.py"), "train", "--dp", "--config",
             os.path.join(tmp, "cfg.json"), "--max-steps", str(DP_CLI_STEPS), "--checkpoint",
             os.path.join(tmp, "cli_ck")], cwd=HERE, env=env, capture_output=True, text=True,
            timeout=900)
        lines = proc.stdout.strip().splitlines()
        want = {k: DP_CLI_STEPS * v + SAMPLER_LAUNCHES[k]
                for k, v in DP_STEP_LAUNCHES[True].items()}
        cli_launches = (json.loads(lines[-1].split(" ", 1)[1])
                        if lines and lines[-1].startswith("launches ") else None)
        log(f"cli train --dp: rc {proc.returncode}, {lines[-2] if len(lines) > 1 else ''}; "
            f"launches {cli_launches} (want {want})")
        if proc.returncode != 0 or cli_launches != want:
            log(proc.stdout[-3000:])
            log(proc.stderr[-3000:])
            raise SystemExit("cli train --dp failed or launched the wrong kernels")
        return {"launches": dp_launches, "cli_launches": cli_launches, "kernels": kernels,
                "batch": batch, "step_s": t_step, "peak_gib": peak, "profile": prof,
                "remat": remat, "allreduce_s": allreduce_s}
    finally:
        dist.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 12: the data x model mesh (vaegan_256_dp)
# ---------------------------------------------------------------------------

MESH_MODEL = 2              # the model axis of every phase-12 mesh
STRIPE_BATCH = 32           # the global batch whose rank (1, 1) part phase 12.2 times
TP_BATCH = 8                # the global batch of 12.3's and 12.4's TP-only runs


def split_kernels(cfg):
    """State-dict names of the critic kernels tensor parallelism over
    :data:`MESH_MODEL` processes splits (``linear_1``-``linear_3`` at the
    notebook's widths)."""
    widths = tuple(cfg.discriminator.linear_widths) + (1,)
    return [f"linear_{j}.weight" for j, w in enumerate(widths, 1) if w % MESH_MODEL == 0]


def whole_from_slices(torch, parts, split):
    """A dict of tensors from the model axis's dicts ``parts`` (in model
    order): each name in ``split`` put back together along its rows, every
    other one model index 0's."""
    return {k: torch.cat([p[k] for p in parts]) if k in split else v
            for k, v in parts[0].items()}


def mesh_rank(rank, world, store, out):
    """One of the four gloo processes of phase 12.1 (run as ``python -c "import
    chip_smoke; chip_smoke.mesh_rank(...)"``): :func:`dp_pair_steps` on the
    2 x 2 mesh with the critic head split and H split over the model axis,
    its results saved to ``out``."""
    import torch

    import vaegan_tpu_torch as vt
    from vaegan_tpu_torch.parallel import dist

    dist.initialize(backend="gloo", init_method=f"file://{store}", world_size=world, rank=rank,
                    device="cuda:0", timeout_s=600)
    try:
        mesh = vt.parallel.make_mesh(num_model=MESH_MODEL)
        res = dp_pair_steps(torch, vt, mesh, spatial=True, tp=True)
        torch.save(res, out)
    finally:
        dist.shutdown()


def run_ranks(what, n, call, tmp, env, timeout=600):
    """``n`` processes of ``python -c "import chip_smoke, sys; chip_smoke.<call>(...)"``
    each with its rank, the world size, a store and an output file; raises
    when one fails; returns their saved results in rank order."""
    import torch

    procs = [subprocess.Popen(
        [sys.executable, "-c", f"import chip_smoke, sys; chip_smoke.{call}(int(sys.argv[1]), "
         f"{n}, sys.argv[2], sys.argv[3])", str(r), os.path.join(tmp, f"{call}_store"),
         os.path.join(tmp, f"{call}{r}.pt")], cwd=HERE, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(n)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        for r, text in enumerate(logs):
            log(f"{what} rank {r}: rc {procs[r].returncode}\n{text[-3000:]}")
        raise SystemExit(f"{what}: a gloo rank failed")
    return [torch.load(os.path.join(tmp, f"{call}{r}.pt"), weights_only=True) for r in range(n)]


def phase_mesh_ranks(torch, vt, tmp, env, card_line):
    """Phase 12.1: four gloo processes on the one card as a 2 x 2 mesh, then
    this process's one-rank step forced onto their gradients step by step
    (:func:`dp_pair_steps`, as phase 11.4), the split kernels' gradients and
    final state put back together from data row 0's two model indices."""
    world = 2 * MESH_MODEL
    log(f"== phase 12.1: a 2 x {MESH_MODEL} mesh (critic head split and H split over the model "
        f"axis), {world} gloo processes on the card against this process's one-rank step, "
        f"vaegan_256_dp in float32 at global batch {DP_RANK_BATCH} (each process 2 rows x 128 "
        "rows of H), two steps (G+D, critic only), cuDNN deterministic; phase 11.4's scheme "
        "and tolerances, each split kernel's gradient and state held whole (data row 0's two "
        "slices); copies compared by checksum; gloo through the host: no NVLink figure ==")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = run_ranks("12.1", world, "mesh_rank", tmp, env)
    wall = time.perf_counter() - t0
    cfg = dp_config(vt, tmp, DP_RANK_BATCH)
    split = split_kernels(cfg)
    row0 = ranks[:MESH_MODEL]
    got = {"metrics": ranks[0]["metrics"], "bn": ranks[0]["bn"],
           "grads": [{net: whole_from_slices(torch, [r["grads"][i][net] for r in row0],
                                             split if net == "d" else ())
                      for net in ranks[0]["grads"][i]} for i in range(2)],
           "state": whole_from_slices(torch, [r["state"] for r in row0],
                                      {f"critic.{k}" for k in split})}
    ref = dp_pair_steps(torch, vt, vt.parallel.Mesh(num_data=1), forced=got["grads"])
    torch.backends.cudnn.deterministic = False
    bad_m = [(i, metrics_close(m, w)) for i, (m, w) in
             enumerate(zip(got["metrics"], ref["metrics"])) if metrics_close(m, w)]
    grads_ok = all(compare_steps(
        f"2 x 2 mesh against one rank, step {i} ({'G+D' if i == 0 else 'critic only'})",
        {"metrics": got["metrics"][i], "grads": got["grads"][i]},
        {"metrics": ref["metrics"][i], "grads": ref["grads"][i]}) for i in range(2))
    bn_err = [held_bn(g, w) for g, w in zip(got["bn"], ref["bn"])]
    state_err = held_state(got["state"], ref["state"])
    bitwise = all(torch.equal(got["state"][k], w) for k, w in ref["state"].items()
                  if not k.endswith(("running_mean", "running_var")))
    # copies: replicated parameters on all four, a split kernel on its model index's two
    sums = [r["checksums"] for r in ranks]
    same = all(sums[r][k] == sums[r % MESH_MODEL if k.split(".", 1)[1] in split else 0][k]
               for r in range(world) for k in sums[0]) and \
        all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    for i, (m, w) in enumerate(zip(got["metrics"], ref["metrics"])):
        log(f"step {i}: 2 x 2 " + ", ".join(f"{k}={m[k]:.7g}" for k in w)
            + "; one rank " + ", ".join(f"{k}={w[k]:.7g}" for k in w))
    bad_bn = [(i, k) for i, errs in enumerate(bn_err) for k, e in errs.items() if e > 1.0]
    bad_state = [k for k, e in state_err.items() if e > 1.0]
    for r, res in enumerate(ranks):
        log(f"rank {r} (data {r // MESH_MODEL}, model {r % MESH_MODEL}): step wall "
            f"{[round(s * 1e3, 1) for s in res['step_s']]} ms; host time in collectives by "
            "kind a step " + "; ".join(
                ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in sorted(c.items()))
                for c in res["collective_s"]) + f" [{card_line}, gloo]")
    log(f"2 x 2 mesh against one rank: metrics out of tolerance {bad_m}; BN statistics out of "
        f"tolerance {bad_bn[:4]} (largest |diff| over its tolerance "
        f"{[round(max(e.values()), 3) for e in bn_err]} after steps 0, 1); final state out of "
        f"tolerance {bad_state[:4]} (the largest |diff| {max(state_err.values()):.3g} of its "
        f"tolerance; bitwise equal {bitwise}); copies agree on every checksum and metric "
        f"{same}; the four processes {wall:.1f} s with their start [{card_line}]")
    if bad_m or bad_bn or bad_state or not same or not grads_ok:
        raise SystemExit("the 2 x 2 mesh step disagrees with the one-rank step")
    return {"step_s": [r["step_s"] for r in ranks],
            "collective_s": [r["collective_s"] for r in ranks], "wall_s": wall}


def phase_stripe_kernels(torch, sites, latent, bounds):
    """Phase 12.2: rows 1-4 on rank (1, 1)'s part of the DP step's bfloat16
    sites at global batch :data:`STRIPE_BATCH` on a 2 x 2 mesh with H split:
    its rows and H stripe, drawn through the stripe index map; each kernel is
    held bitwise against its plain version with the same map, and rows 1 and
    3 against the kernel on the global tensor cut to the same part."""
    from vaegan_tpu_torch.ops import fused
    from vaegan_tpu_torch.ops.replica import Replica

    rep = Replica(rank=1, world=2, model_rank=1, num_model=MESH_MODEL, spatial=True)
    log(f"== phase 12.2: rows 1-4 with the stripe index map on rank (1, 1)'s rows and H stripe "
        f"of the 12 generator sites of a vaegan_256_dp step (bfloat16, global batch "
        f"{STRIPE_BATCH}: {STRIPE_BATCH // 2} rows x H/{MESH_MODEL} each), bitwise against "
        "their plain versions with the same map and (rows 1, 3) against the kernel on the "
        "global tensor cut to the part; kernel: median of 5 CUDA-event windows of 20 launches, "
        "inputs rotated through >= 256 MB; plain: one window of 2; the contiguous map (L = G) "
        "is phase 11.3's ==")
    g = torch.Generator(device="cuda").manual_seed(SEED + 13)
    cl = lambda t: t.contiguous(memory_format=torch.channels_last)  # noqa: E731
    bf16 = torch.bfloat16
    out = {k: {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": "bytes",
               "issue_ms": 0.0, "max_abs_err": 0.0, "sites": 0, "dtype": "bfloat16",
               "batch": STRIPE_BATCH,
               "part": f"rows {STRIPE_BATCH // 2}-{STRIPE_BATCH - 1}, stripe 1 of {MESH_MODEL}"}
           for k in ("bn_act_dropout", "bn_act_dropout_bwd", "reparam_kl", "reparam_kl_bwd")}
    note = site_notes(out)

    for i, (c, h, w) in enumerate(sites):
        p = 0.5 if i % 2 == 0 else 0.0          # bn1 drops at 0.5, bn2 at 0
        mean = torch.randn(c, device="cuda", generator=g) * 0.3
        var = torch.rand(c, device="cuda", generator=g) + 0.5
        scale = torch.rand(c, device="cuda", generator=g) + 0.5
        bias = torch.randn(c, device="cuda", generator=g) * 0.1
        full = cl(torch.randn(STRIPE_BATCH, c, h, w, device="cuda", generator=g).to(bf16))
        x = cl(rep.take(full, 2))
        gy = cl(torch.randn(x.shape, device="cuda", generator=g).to(bf16))
        base, big_l, big_g = rep.index_map(x.shape)
        n, seed = x.numel(), 6200 + i
        args = (mean, var, scale, bias, seed, SLOPE, p, 1e-5, base, (big_l, big_g))
        y = fused.bn_act_dropout_forward(x, *args)
        r = fused.bn_act_dropout_reference(x, *args)
        cut = rep.take(fused.bn_act_dropout_forward(full, *args[:-2]), 2)
        k = fused.bn_act_dropout_backward(x, gy, *args)
        kr = fused.bn_act_dropout_backward_reference(x, gy, *args)
        torch.cuda.synchronize()
        if not (torch.equal(y, r) and torch.equal(y, cut) and torch.equal(k[0], kr[0])):
            raise SystemExit(f"row 1/2 site {i} on the stripe: y or dx is not bitwise the plain "
                             "version's, or y is not the global kernel's part")
        del full, cut
        err = max(check_close(f"row 2 site {i} {nm}", k[j], kr[j], bf16, True)
                  for j, nm in enumerate(("dscale", "dbias", "dmean", "dvar"), 1))
        rot = rotation(x, gy)
        k1 = time_cuda(torch, lambda j: fused.bn_act_dropout_forward(rot[j % len(rot)][0], *args))
        p1 = time_cuda(torch, lambda j: fused.bn_act_dropout_reference(rot[j % len(rot)][0],
                                                                       *args),
                       reps=2, windows=1, warmup=1)
        b1 = bounds(2 * n * 2 + 4 * c * 4, n, "bn_act_dropout_fwd_kernel", bf16, None, p > 0,
                    p > 0)
        note("bn_act_dropout", k1, p1, b1, 0.0)
        k2 = time_cuda(torch, lambda j: fused.bn_act_dropout_backward(*rot[j % len(rot)], *args))
        p2 = time_cuda(torch, lambda j: fused.bn_act_dropout_backward_reference(
            *rot[j % len(rot)], *args), reps=2, windows=1, warmup=1)
        launch = fused.bwd_launch_for(x, p, True)
        b2 = bounds(3 * n * 2 + 8 * c * 4, n, "bn_act_dropout_bwd_kernel", bf16, launch.vec,
                    p > 0, p > 0)
        note("bn_act_dropout_bwd", k2, p2, b2, err)
        log(f"site {i:2d} C={c:3d} HxW={h}x{w} p={p} base={base} L={big_l} G={big_g}: y and dx "
            f"bitwise equal, y the global kernel's part, sums max_abs_err={err:.3e}; row 1 "
            f"kernel_ms={k1:.4f} plain_ms={p1:.4f} bound_ms={b1[0]:.4f} ({b1[1]}); row 2 "
            f"kernel_ms={k2:.4f} plain_ms={p2:.4f} bound_ms={b2[0]:.4f} ({b2[1]})")
        del x, gy, y, r, k, kr, rot
        torch.cuda.empty_cache()

    h, w, c = latent
    full_mu = cl(torch.randn((STRIPE_BATCH, c, h, w), device="cuda", generator=g)).to(bf16)
    full_lv = cl(torch.randn((STRIPE_BATCH, c, h, w), device="cuda", generator=g) * 0.5).to(bf16)
    mu, lv = cl(rep.take(full_mu, 2)), cl(rep.take(full_lv, 2))
    gz = cl(torch.randn(mu.shape, device="cuda", generator=g)).to(bf16)
    base, big_l, big_g = rep.index_map(mu.shape)
    st, n = (big_l, big_g), mu.numel()
    z, kl = fused.reparam_kl_forward(mu, lv, 88, base, st)
    zr, klr = fused.reparam_kl_reference(mu, lv, 88, base, st)
    cut = rep.take(fused.reparam_kl_forward(full_mu, full_lv, 88)[0], 2)
    d = fused.reparam_kl_backward(mu, lv, gz, None, 88, base, st)
    dr = fused.reparam_kl_backward_reference(mu, lv, gz, None, 88, base, st)
    torch.cuda.synchronize()
    if not (torch.equal(z, zr) and torch.equal(z, cut)
            and all(torch.equal(a, b) for a, b in zip(d, dr))):
        raise SystemExit("rows 3/4 on the stripe: z, dmu or dlv is not bitwise the plain "
                         "version's, or z is not the global kernel's part")
    del full_mu, full_lv, cut
    err3 = check_close("row 3 kl", kl, klr, bf16, True)
    rot = rotation(mu, lv, gz)
    k3 = time_cuda(torch, lambda j: fused.reparam_kl_forward(*rot[j % len(rot)][:2], 88, base,
                                                             st))
    p3 = time_cuda(torch, lambda j: fused.reparam_kl_reference(*rot[j % len(rot)][:2], 88, base,
                                                               st),
                   reps=2, windows=1, warmup=1)
    b3 = bounds(3 * n * 2 + 4, n, "reparam_fwd_kernel", bf16, striped=True)
    note("reparam_kl", k3, p3, b3, err3)
    k4 = time_cuda(torch, lambda j: fused.reparam_kl_backward(*rot[j % len(rot)], None, 88, base,
                                                              st))
    p4 = time_cuda(torch, lambda j: fused.reparam_kl_backward_reference(*rot[j % len(rot)], None,
                                                                        88, base, st),
                   reps=2, windows=1, warmup=1)
    b4 = bounds(5 * n * 2, n, "reparam_bwd_kernel", bf16, striped=True, kl=False)
    note("reparam_kl_bwd", k4, p4, b4, 0.0)
    grids = row4_grids(torch, fused, rot, 88, base, st)
    log(f"rows 3/4 {tuple(mu.shape)} base={base} L={big_l} G={big_g}: z, dmu, dlv bitwise "
        f"equal, z the global kernel's part, kl {float(kl)!r} vs plain {float(klr)!r}; row 3 "
        f"kernel_ms={k3:.4f} plain_ms={p3:.4f} bound_ms={b3[0]:.4f} ({b3[1]}); row 4 "
        f"kernel_ms={k4:.4f} plain_ms={p4:.4f} bound_ms={b4[0]:.4f} ({b4[1]}; SASS issue "
        f"{b4[3]:.4f}); {grids}")
    for name, o in out.items():
        log(f"{name} with the stripe map over {o['sites']} site(s): kernel {o['ms']:.4f} ms, "
            f"plain {o['plain_ms']:.4f} ms, bound {o['bound_ms']:.4f} ms ({o['bound_by']}; "
            f"{100 * o['bound_ms'] / o['ms']:.1f}% of the bound's time; SASS issue "
            f"{o['issue_ms']:.4f} ms)")
    del mu, lv, gz, z, zr, d, dr, rot
    torch.cuda.empty_cache()
    return out


def tp_config(vt, tmp, **train):
    """:func:`dp_config` at global batch :data:`TP_BATCH` with
    ``parallel.num_model`` :data:`MESH_MODEL`: tensor parallelism of the
    critic head through ``train_data_parallel``."""
    cfg = dp_config(vt, tmp, TP_BATCH, **train)
    return cfg.replace(parallel=cfg.parallel.replace(num_model=MESH_MODEL))


def tp_rank(rank, world, store, out):
    """One of the two gloo processes of phase 12.3 (run as :func:`mesh_rank`
    is): phase 11.1's three runs of ``train_data_parallel`` (:func:`dp_loop`)
    of :func:`tp_config`, launches counted from 0 just before them, folders
    next to ``store``; saves each step's launches, the checks, the seconds a
    step of the resumed run and the final critic state."""
    import torch

    import vaegan_tpu_torch as vt
    from vaegan_tpu_torch.checkpoint import CheckpointManager
    from vaegan_tpu_torch.ops import fused
    from vaegan_tpu_torch.parallel import dist
    from vaegan_tpu_torch.utils.metrics import MetricsLogger

    dist.initialize(backend="gloo", init_method=f"file://{store}", world_size=world, rank=rank,
                    device="cuda:0", timeout_s=600)
    try:
        cfg = tp_config(vt, os.path.dirname(store))
        mesh = vt.parallel.make_mesh(num_model=MESH_MODEL)
        logger_class, made = launch_logger(fused, MetricsLogger), []

        def logger(**kw):
            made.append(logger_class(sinks=[], **kw))
            return made[-1]

        torch.cuda.synchronize()
        fused.reset_launches()
        state, per_step, history, diff = dp_loop(torch, vt, cfg, mesh, fused, logger,
                                                 device="cuda:0")
        torch.cuda.synchronize()
        last = made[-1].history[-1]
        res = {"launches": dict(fused.LAUNCHES), "per_step": per_step, "diff": diff,
               "finite": all(v == v and abs(v) != float("inf") for m in history
                             for v in m.values()),
               "steps": len(per_step), "step_s": last["_wall_s"] / max(last["_steps"], 1),
               "grids": sorted(os.listdir(cfg.train.sample_dir)),
               "kept": CheckpointManager(cfg.train.checkpoint_dir).all_steps(),
               "critic": {k: v.cpu() for k, v in state.critic.state_dict().items()}}
        torch.save(res, out)
    finally:
        dist.shutdown()


def phase_mesh(torch, vt, bounds, card_line, sites, latent):
    """Phase 12: the data x model mesh of ``vaegan_256_dp`` (module
    docstring)."""
    import shutil

    from vaegan_tpu_torch.checkpoint import CheckpointManager

    tmp = tempfile.mkdtemp(prefix="vaegan_mesh_")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p))
    try:
        # ---- 12.1 the 2 x 2 step against one rank
        mesh_steps = phase_mesh_ranks(torch, vt, tmp, env, card_line)

        # ---- 12.2 rows 1-4 on a stripe
        kernels = phase_stripe_kernels(torch, sites, latent, bounds)

        # ---- 12.3 tensor parallelism alone through the loop: the counts are set to
        # 0 in each process just before its runs and read just after
        cfg = tp_config(vt, tmp)
        log(f"== phase 12.3: train_data_parallel of vaegan_256_dp with parallel.num_model="
            f"{MESH_MODEL} (the critic head split over the model axis, each process the whole "
            f"global batch of {TP_BATCH}; bfloat16, use_pallas='all', remat on), {MESH_MODEL} "
            "gloo processes on the card: phase 11.1's three runs (2 steps and a checkpoint, a "
            "resume that restores it bitwise, 2 more steps) with each step's launches exact; "
            "the last checkpoint restored into a one-process state ==")
        t0 = time.perf_counter()
        runs = run_ranks("12.3", MESH_MODEL, "tp_rank", tmp, env, timeout=900)
        wall = time.perf_counter() - t0
        split = split_kernels(cfg)
        bad = []
        for r, res in enumerate(runs):
            wrong = [i for i, (got, (g, grid)) in enumerate(zip(res["per_step"], DP_PLAN))
                     if got != dp_step_launches(g, grid)]
            log(f"tp rank {r}: {res['steps']} steps, launches {res['launches']}, per step "
                f"{res['per_step']}; metrics finite={res['finite']}, restore of step 2 bitwise "
                f"{'equal' if not res['diff'] else 'DIFFERS at ' + str(res['diff'][:4])}, grids "
                f"{res['grids']}, checkpoints {res['kept']}; a step of the resumed run "
                f"{res['step_s'] * 1e3:.1f} ms [{card_line}, gloo]")
            if (wrong or res["steps"] != len(DP_PLAN) or not res["finite"] or res["diff"]
                    or res["kept"] != [2, 4] or res["grids"] != ["0.png", "2.png"]
                    or not all(res["launches"].values())):
                bad.append(r)
        whole = whole_from_slices(torch, [res["critic"] for res in runs], split)
        one = CheckpointManager(cfg.train.checkpoint_dir).restore(
            vt.create_train_state(cfg.replace(parallel=cfg.parallel.replace(num_model=1)),
                                  device="cuda", seed=SEED))
        restored = {k: v.cpu() for k, v in one.critic.state_dict().items()}
        same = restored.keys() == whole.keys() and all(torch.equal(restored[k], whole[k])
                                                       for k in whole)
        shapes = {k: tuple(runs[0]["critic"][k].shape) for k in split}
        log(f"tp path: split kernels {shapes} on each process; the step-4 checkpoint restored "
            f"into a one-process state equals the processes' critic put back together "
            f"bitwise: {same}; the two processes {wall:.1f} s with their start [{card_line}]")
        del one, restored, whole
        torch.cuda.empty_cache()
        if bad or not same:
            raise SystemExit(f"tp path: wrong launches, a non-finite metric, a restore that "
                             f"differs or missing grids or checkpoints on ranks {bad}, or a "
                             "checkpoint that does not restore into one process")

        # ---- 12.4 cli train --dp with num_model 2, and the dry run
        log(f"== phase 12.4: torchrun --standalone --nproc_per_node={MESH_MODEL} -m "
            "vaegan_tpu_torch.cli train --dp --device cuda:0 (gloo, which the process group "
            f"picks since the processes share the card; vaegan_256_dp with "
            f"parallel.num_model={MESH_MODEL}, use_pallas all, remat on, global batch "
            f"{TP_BATCH}, {DP_CLI_STEPS} steps), launches counted per process; "
            "entry.dryrun_multichip(4) on the CPU meanwhile ==")
        with open(os.path.join(tmp, "count.py"), "w") as f:
            f.write(CLI_COUNTING)
        c = tp_config(vt, tmp, n_critics=1, n_epochs=1,
                      sample_dir=os.path.join(tmp, "cli_samples"), checkpoint_dir=None)
        with open(os.path.join(tmp, "cfg_tp.json"), "w") as f:
            json.dump(c.to_dict(), f)
        from vaegan_tpu_torch.entry import dryrun_multichip

        # the dry run (CPU processes) runs while torchrun's processes use the card
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc_per_node={MESH_MODEL}", os.path.join(tmp, "count.py"), "train", "--dp",
             "--device", "cuda:0", "--config",
             os.path.join(tmp, "cfg_tp.json"), "--max-steps", str(DP_CLI_STEPS),
             "--checkpoint", os.path.join(tmp, "cli_tp_ck")], cwd=HERE, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                dryrun_multichip(4)
            dry_s = time.perf_counter() - t0
            out, err = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        want = {k: DP_CLI_STEPS * v + SAMPLER_LAUNCHES[k]
                for k, v in DP_STEP_LAUNCHES[True].items()}
        cli_launches = [json.loads(line.split(" ", 1)[1]) for line in out.splitlines()
                        if line.startswith("launches ")]
        done = out.count(f"done: {DP_CLI_STEPS} steps")
        log(f"cli train --dp (num_model {MESH_MODEL}): rc {proc.returncode} after "
            f"{time.perf_counter() - t0:.1f} s, 'done' on {done} processes; launches per "
            f"process {cli_launches} (want {want} each)")
        if proc.returncode != 0 or cli_launches != [want] * MESH_MODEL or done != MESH_MODEL:
            log(out[-3000:])
            log(err[-3000:])
            raise SystemExit("cli train --dp with a model axis failed or launched the wrong "
                             "kernels")
        line = printed.getvalue().strip()
        log(f"{line} ({dry_s:.1f} s, beside torchrun's)")
        if "dryrun_multichip(4) ok (mesh data=2 x model=2, dp + critic-head tp + spatial " \
                "sharding" not in line:
            raise SystemExit("dryrun_multichip(4) did not run the 2-D mesh")
        return {"mesh": mesh_steps, "kernels": kernels, "tp_launches": runs[0]["launches"],
                "tp_step_s": [res["step_s"] for res in runs], "cli_launches": cli_launches[0]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# One tree's kernel phases (5, 11.3 and, where the tree has it, 12.2), run from the
# root of that tree with its own chip_smoke.py and package: :func:`paired_kernels`.
# ---------------------------------------------------------------------------
# phase 13: bench --roofline and the exported serving bundle
# ---------------------------------------------------------------------------

# (label, bench arguments, environment) of each roofline run, and its step's launches
ROOFLINE_RUNS = (("notebook G+D step", (), {}),
                 ("vaegan_paper step", ("--paper",), {}),
                 ("notebook critic-only step", (), {"BENCH_CRITIC_ONLY": "1"}))
ROOFLINE_LAUNCHES = (STEP_LAUNCHES[True], PAPER_LAUNCHES, STEP_LAUNCHES[False])
# timed steps of each roofline run (the bench's default is 20; a G+D step with
# the penalty takes about 1.25 s there; 5 until phase 15 was added)
ROOFLINE_STEPS = "2"
# the data sheet's memory rate with a 5% margin: no triad reads above it
TRIAD_CEILING_GBS = 3.35e3 * 1.05


def forward_flops(torch, vt, cfg, batch):
    """Analytic flops (2 a multiply-add) of one generator forward and one critic
    forward at ``batch``, from each convolution's and linear's shapes."""
    from vaegan_tpu_torch.models.layers import Conv2D, Linear

    gen, critic = vt.build_models(cfg, device="cuda")
    total = {}

    def hook(name):
        def count(mod, inp, out):
            if isinstance(mod, Linear):
                n = 2 * out.numel() * inp[0].shape[-1]
            else:
                w = mod.weight_orig if mod.spectral else mod.weight
                k = w.shape[-1] * w.shape[-2]
                n = 2 * (inp[0].numel() * w.shape[1] if mod.transpose
                         else out.numel() * w.shape[1]) * k
            total[name] = total.get(name, 0) + n * batch
        return count

    size = cfg.data.image_size
    with torch.no_grad():
        for name, net in (("generator", gen), ("critic", critic)):
            hooks = [m.register_forward_hook(hook(name)) for m in net.modules()
                     if isinstance(m, (Conv2D, Linear))]
            x = torch.rand(1, size, size, 1, device="cuda")
            net(x, train=False)
            for h in hooks:
                h.remove()
    del gen, critic
    return total


TRIAD_PROFILE = """
import json, torch
import chip_smoke as cs
from vaegan_tpu_torch import bench
y = torch.ones(bench.TRIAD_ELEMENTS, device="cuda")
b = torch.full((bench.TRIAD_ELEMENTS,), 2.0, device="cuda")
print("TRIAD " + json.dumps(cs.profile_split(torch, lambda i: bench.triad_rep(y, b), calls=5)))
"""


def phase_roofline(torch, vt, card_line):
    """13.1: ``python -m vaegan_tpu_torch.bench --roofline`` with the kernels on,
    on the notebook G+D step, ``--paper`` and the critic-only step; the triad
    is one kernel a repetition. Returns each run's JSON line."""
    from vaegan_tpu_torch import bench

    log(f"== phase 13.1: bench --roofline, BENCH_PALLAS=all, BENCH_STEPS={ROOFLINE_STEPS}, the "
        f"JAX bench's defaults (96x96, batch 128, bfloat16, {bench.TRIAD_REPS} triad repetitions over "
        f"{bench.TRIAD_ELEMENTS} float32 elements an array) [{card_line}] ==")
    # in a process of its own: in this long run torch.profiler records fewer of
    # the device events the later it profiles (19, 11, then 7 of 20 launches),
    # and it once recorded none here
    proc = subprocess.run([sys.executable, "-c", TRIAD_PROFILE], cwd=HERE, capture_output=True,
                          text=True, timeout=300)
    out = [x for x in proc.stdout.splitlines() if x.startswith("TRIAD ")]
    if proc.returncode or not out:
        raise SystemExit(f"the triad's profile: rc {proc.returncode}\n{proc.stderr[-3000:]}")
    split = {k: tuple(v) for k, v in json.loads(out[0][6:]).items()}
    log(f"triad repetition under torch.profiler: {split_text(split, 5)}")
    if len(split) != 1:
        raise SystemExit(f"the triad is not one kernel a repetition: {split}")
    lines = []
    for (label, args, env), want in zip(ROOFLINE_RUNS, ROOFLINE_LAUNCHES):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "vaegan_tpu_torch.bench", "--roofline",
                               *args], cwd=HERE, env=dict(os.environ, BENCH_PALLAS="all",
                                                          BENCH_STEPS=ROOFLINE_STEPS, **env),
                              capture_output=True, text=True, timeout=600)
        out = [x for x in proc.stdout.splitlines() if x.startswith("{")]
        if proc.returncode or not out:
            raise SystemExit(f"bench --roofline ({label}): rc {proc.returncode}\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
        rec = json.loads(out[-1])
        log(json.dumps(rec))
        # launches: fused.LAUNCHES over the timed steps and over the counted
        # one; calls: what the cost count was told at those launches
        calls = {k: v["calls"] for k, v in rec["kernels"].items()}
        kernel_bytes = sum(v["bytes"] for v in rec["kernels"].values())
        kernel_flops = sum(v["flops"] for v in rec["kernels"].values())
        steps = rec["timed_steps"]
        log(f"{label}: {time.perf_counter() - t0:.1f} s of wall; counted bytes "
            f"{rec['step_cost_bytes'] / 1e9:.3f} GB (the kernels' "
            f"{kernel_bytes / 1e9:.4f} GB, {100 * kernel_bytes / rec['step_cost_bytes']:.3f}%), "
            f"parameters + gradients + optimizer state {rec['state_bytes'] / 1e9:.3f} GB; "
            f"launches over the {steps} timed steps {rec['launches']}, in the counted step "
            f"{rec['counted_step_launches']} (want {want} a step), the cost count's kernel "
            f"calls {calls} [{card_line}]")
        if rec["achieved_hbm_gbs_triad"] > TRIAD_CEILING_GBS:
            raise SystemExit(f"{label}: the triad reads above the data sheet's memory rate")
        if rec["fraction_of_achieved_bw"] > 1.05:
            raise SystemExit(f"{label}: the step's implied rate is above the achieved one")
        if rec["step_cost_bytes"] < rec["state_bytes"]:
            raise SystemExit(f"{label}: fewer bytes counted than the state a step updates")
        if (rec["launches"] != {k: v * steps for k, v in want.items()}
                or rec["counted_step_launches"] != want):
            raise SystemExit(f"{label}: the step's kernel launches are not the path's")
        if calls != {k: v for k, v in want.items() if v} or kernel_bytes <= 0:
            raise SystemExit(f"{label}: the kernels' share of the counted step is missing or "
                             "disagrees with its launches")
        rec["label"], rec["kernel_flops"], rec["wall_s"] = (label, kernel_flops,
                                                            time.perf_counter() - t0)
        lines.append(rec)
    cfg = vt.preset("notebook")
    cfg = cfg.replace(data=cfg.data.replace(image_size=96),
                      train=cfg.train.replace(dtype="bfloat16"))
    fwd = forward_flops(torch, vt, cfg, 128)
    g_d = lines[0]["step_cost_flops"] - lines[0]["kernel_flops"]
    log(f"notebook G+D step at 96x96, batch 128: counted convolution and matmul flops "
        f"{g_d / 1e12:.4f} T; analytic forward flops from the shapes: generator "
        f"{fwd['generator'] / 1e12:.4f} T, critic {fwd['critic'] / 1e12:.4f} T a forward "
        f"(the step runs the generator forward once and the critic forward on real, fake, "
        f"interpolates and the G half's fakes, then their backwards and the penalty's "
        f"double backward): counted / (generator + 4 critic forwards) "
        f"{g_d / (fwd['generator'] + 4 * fwd['critic']):.3f}")
    return lines


def bundle_weights_equal(torch, gen, bundle):
    """Whether every program of ``bundle`` holds ``gen``'s parameters and
    buffers bit for bit (at least every parameter)."""
    sd = gen.state_dict()
    params = {k for k, _ in gen.named_parameters()}
    for ep in bundle.programs.values():
        held = {k.removeprefix("generator."): v for k, v in ep.state_dict.items()}
        if not params <= set(held) or not all(torch.equal(sd[k], v) for k, v in held.items()):
            return False
    return True


def phase_bundle(torch, vt, cfg, state, images, z8, t64, t1, card_line):
    """13.2: bundles of the served model exported on the card (a symbolic batch
    and one pinned at 64) and on the CPU for ("cpu", "cuda"), loaded on the
    card and held against the in-process entry points; 12 row-1 launches a
    reconstruct; the bundle's serving numbers beside phase 4's. Returns row 1's
    launches over the phase."""
    from vaegan_tpu_torch.ops import fused
    from vaegan_tpu_torch.serving import load_bundle, save_bundle

    log(f"== phase 13.2: serving bundles as exported programs (vaegan_infer, "
        f"{cfg.data.image_size}x{cfg.data.image_size}, float32, use_pallas='all'; against the "
        "in-process call under cudnn.deterministic, since cuDNN's default transposed "
        "convolutions differ run to run by ~1e-6 of the scale: tolerance 1e-6 of max|ref|, "
        "bitwise equality printed) ==")
    gen = state.generator
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    with torch.inference_mode():
        ref = {"reconstruct b64": vt.reconstruct(cfg, state, images),
               "reconstruct b1": vt.reconstruct(cfg, state, images[:1]),
               "encode b8": gen.encode(images[:8]), "decode b8": gen.decode(z8)}
    gen_cpu = vt.build_generator(cfg, device="cpu")
    gen_cpu.load_state_dict({k: v.cpu() for k, v in gen.state_dict().items()}, strict=True)
    bundles, wall = {}, {}
    with tempfile.TemporaryDirectory(prefix="vaegan_bundle_") as tmp:
        for name, st, kw in (("card, symbolic batch", state, {}),
                             (f"card, batch {BATCH}", state, {"batch_size": BATCH}),
                             ("CPU host for cpu+cuda", state.replace(generator=gen_cpu),
                              {"platforms": ("cpu", "cuda")})):
            d = os.path.join(tmp, str(len(bundles)))
            t0 = time.perf_counter()
            save_bundle(d, cfg, st, **kw)
            wall[name] = time.perf_counter() - t0
            bundles[name] = load_bundle(d, device="cuda")
            with open(os.path.join(d, "manifest.json")) as f:
                m = json.load(f)
            log(f"{name}: exported in {wall[name]:.1f} s, manifest batch {m['batch']!r}, "
                f"platforms {m['platforms']}, weights bitwise in every program="
                f"{bundle_weights_equal(torch, gen, bundles[name])}")
            if not bundle_weights_equal(torch, gen, bundles[name]):
                raise SystemExit(f"{name}: the bundle does not hold the generator's weights")
    del gen_cpu
    total = 0
    for name, bundle in bundles.items():
        pinned = bundle.manifest["batch"] != "symbolic"
        calls = [("reconstruct b64", 12, lambda: bundle.reconstruct(images))]
        if not pinned:
            calls += [("reconstruct b1", 12, lambda: bundle.reconstruct(images[:1])),
                      ("encode b8", 6, lambda: bundle.encode(images[:8])),
                      ("decode b8", 6, lambda: bundle.decode(z8))]
        for req, want, call in calls:
            fused.reset_launches()
            out = call()
            torch.cuda.synchronize()
            got = fused.LAUNCHES["bn_act_dropout"]
            total += got
            outs, refs = (out, ref[req]) if isinstance(out, tuple) else ((out,), (ref[req],))
            errs = [float((a - r).abs().max()) / max(float(r.abs().max()), 1e-30)
                    for a, r in zip(outs, refs)]
            bitwise = all(torch.equal(a, r) for a, r in zip(outs, refs))
            log(f"{name}: {req} {[tuple(a.shape) for a in outs]}: bitwise={bitwise}, "
                f"max_abs_err / max|ref| {max(errs):.3e}, bn_act_dropout launches {got} "
                f"(want {want})")
            if got != want or max(errs) > 1e-6:
                raise SystemExit(f"{name}: {req} disagrees with the in-process call or missed "
                                 "the kernel")
        if pinned:
            try:
                bundle.reconstruct(images[:1])
            except Exception as e:      # the program's input guard; any type will do
                log(f"{name}: batch 1 refused ({type(e).__name__})")
            else:
                raise SystemExit(f"{name}: a pinned bundle served another batch size")
    torch.backends.cudnn.deterministic = deterministic
    sym = bundles["card, symbolic batch"]
    b64 = time_host(torch, lambda: sym.reconstruct(images), reps=10)
    b1 = time_host(torch, lambda: sym.reconstruct(images[:1]), reps=50, warmup=5)
    log(f"bundle reconstruct batch {BATCH}: {b64 * 1e3:.3f} ms median, {BATCH / b64:.1f} "
        f"images/s (in-process, phase 4: {t64 * 1e3:.3f} ms, {BATCH / t64:.1f} images/s) "
        f"[{card_line}]")
    log(f"bundle reconstruct batch 1 latency: {b1 * 1e3:.3f} ms median of 50 (in-process, "
        f"phase 4: {t1 * 1e3:.3f} ms) [{card_line}]")
    return total


# ---------------------------------------------------------------------------
# phase 14: the user journeys (vaegan_tpu_torch.examples), each in its own process
# ---------------------------------------------------------------------------
JOURNEY_STEPS = 8          # reproduce_headline's steps (20 until phase 15 was added)
# reproduce_headline's train() with its kernel launches printed on a line of
# their own (as CLI_COUNTING does for the CLI's train)
HEADLINE_COUNTING = ("import json, os, sys\n"
                     "import torch\n"
                     "from vaegan_tpu_torch.examples import reproduce_headline as rh\n"
                     "from vaegan_tpu_torch.ops import fused\n"
                     "train = rh.train\n"
                     "def counted(cfg, **kw):\n"
                     "    fused.reset_launches()\n"
                     "    out = train(cfg, **kw)\n"
                     "    torch.cuda.synchronize()\n"
                     "    sys.stdout.flush()\n"
                     "    os.write(1, ('\\nlaunches ' + json.dumps(dict(fused.LAUNCHES)) + '\\n')"
                     ".encode())\n"
                     "    return out\n"
                     "rh.train = counted\n"
                     "rh.main(sys.argv[1:])\n")
# each run's steps are G+D (n_critics 1) and the sampler draws a grid before step 0
HEADLINE_RUNS = (("VAE-GAN", [], STEP_LAUNCHES[True]),
                 ("plain-VAE", ["--vae"], STEP_LAUNCHES[True]),
                 ("VAE-GAN-paper", ["--preset", "vaegan_paper"], PAPER_LAUNCHES))
HBM_BATCH = 8               # 14.4: the global batch, 2 processes x 2 microbatches
JOURNEY_CLOSING = re.compile(r"^trained (\d+) steps over (\d+) devices \((\d+) process\(es\)\) "
                             r"— ([0-9.]+) img/s$")


def journey_launches(per_step):
    return {k: JOURNEY_STEPS * v + SAMPLER_LAUNCHES[k] for k, v in per_step.items()}


def hbm_rank(rank, world, store, out):
    """One of 14.4's two gloo processes on the card: ``make_loader`` with
    ``hbm_cache`` (the dataset staged on the card, its rows of each of 2
    microbatches gathered there) against the rank-sharded host ``DataLoader``
    over one epoch, batch for batch bitwise; the count saved to ``out``."""
    import numpy as np
    import torch

    import vaegan_tpu_torch as vt
    from vaegan_tpu_torch.data import pipeline
    from vaegan_tpu_torch.parallel import dist

    dist.initialize(backend="gloo", init_method=f"file://{store}", world_size=world, rank=rank,
                    device="cuda:0", timeout_s=600)
    try:
        d = vt.preset("notebook").data.replace(batch_size=HBM_BATCH, synthetic=True,
                                               hbm_cache=True)
        dev = pipeline.make_loader(d, seed=SEED, device="cuda:0", microbatches=2)
        host = pipeline.DataLoader(pipeline.make_dataset(d), batch_size=HBM_BATCH, seed=SEED,
                                   prefetch_batches=0, process_index=rank, process_count=world,
                                   microbatches=2)
        if not isinstance(dev, pipeline.DeviceDataLoader) or dev.images.device.type != "cuda":
            raise SystemExit("make_loader did not stage the dataset on the card")
        n = equal = 0
        for got, want in zip(dev, host, strict=True):
            n += 1
            equal += int(got.is_cuda and np.array_equal(got.cpu().numpy(), want))
        torch.save({"batches": n, "equal": equal, "rows": int(got.shape[0]),
                    "staged_mib": dev.images.numel() * 4 // 2 ** 20}, out)
    finally:
        dist.shutdown()


def finite(values):
    return all(isinstance(v, (int, float)) and v == v and abs(v) != float("inf")
               for v in values)


def phase_journeys(torch, vt, card_line):
    """Phase 14: the three journeys of ``vaegan_tpu_torch.examples`` on the card,
    each in its own process (the independent ones started together): 14.1
    ``reproduce_headline`` at 256², batch 4, float32, the kernels on, for
    ``notebook``, ``--vae`` and ``--preset vaegan_paper`` (JSON line parsed,
    every number finite, the train's launches exact, the paper run's EMA
    draws present); 14.2 ``train_vaegan`` (its three PNGs, a finite MSE); 14.3
    ``train_multichip`` as two gloo processes sharing the card and under
    ``torchrun --nproc_per_node=1`` (NCCL, a world of one); 14.4 the
    ``hbm_cache`` loader in two gloo processes on the card against the
    rank-sharded host loader. Returns 14.1's VAE-GAN launches (the journey
    path)."""
    import shutil

    t14 = time.perf_counter()
    # the journeys' processes share the card with this one: hand back what
    # this process's allocator keeps cached from the earlier phases
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"phase 14: this process holds {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
        f"({torch.cuda.memory_reserved() / 2 ** 30:.2f} GiB reserved) of the card")
    tmp = tempfile.mkdtemp(prefix="vaegan_journeys_")
    try:
        log(f"== phase 14.1 and 14.4: reproduce_headline (256x256, batch 4, float32, use_pallas "
            f"all, {JOURNEY_STEPS} steps, 3 draws, BN recalibrated from 5 batches) for "
            "notebook, --vae and --preset vaegan_paper, launches counted; the hbm_cache loader "
            "in two gloo processes on the card; all started together ==")
        flags = ["--image-size", "256", "--batch-size", "4", "--dtype", "float32",
                 "--use-pallas", "all", "--max-steps", str(JOURNEY_STEPS), "--draws", "3",
                 "--recalibrate-bn", "5"]
        with open(os.path.join(tmp, "count.py"), "w") as f:
            f.write(HEADLINE_COUNTING)
        commands = [(f"reproduce_headline {label}",
                     [sys.executable, os.path.join(tmp, "count.py"), *extra, *flags, "--out",
                      os.path.join(tmp, f"headline{i}")])
                    for i, (label, extra, _) in enumerate(HEADLINE_RUNS)]
        commands.append(("hbm_cache ranks", [
            sys.executable, "-c", "import sys, chip_smoke\nchip_smoke.hbm_ranks(sys.argv[1])\n",
            tmp]))
        outs = run_together(commands, timeout=600)
        journey = None
        for (label, _, per_step), out in zip(HEADLINE_RUNS, outs):
            lines = out.strip().splitlines()
            launches = json.loads(next(l for l in reversed(lines)
                                       if l.startswith("launches "))[len("launches "):])
            rec = json.loads(next(l for l in reversed(lines) if l.startswith("{")))
            want = journey_launches(per_step)
            numbers = [*rec["eval_mse_repeat_draws"], rec["eval_mse_mean_predictor_floor"],
                       *rec["eval_mse_repeat_draws_bn_recalibrated"],
                       *rec.get("eval_mse_repeat_draws_ema", []),
                       *rec["final_train_metrics"].values(), rec["train_wall_s"]]
            log(f"14.1 {label}: {json.dumps(rec)} [{card_line}]")
            log(f"14.1 {label}: train launches {launches} (want {want})")
            ok = (rec["run"] == label and rec["steps"] == JOURNEY_STEPS and finite(numbers)
                  and len(rec["eval_mse_repeat_draws"]) == 3 and launches == want)
            if label == "VAE-GAN-paper":
                ok = ok and len(rec.get("eval_mse_repeat_draws_ema", [])) == 3
            if not ok:
                raise SystemExit(f"14.1 reproduce_headline {label}: a wrong record, a "
                                 "non-finite number or wrong launches")
            if label == "VAE-GAN":
                journey = launches
        hbm = [line for line in outs[-1].splitlines() if line.startswith("14.4")]
        for line in hbm:
            log(line)

        log("== phase 14.2 and 14.3: train_vaegan (--epochs 1 --image-size 96 --batch-size "
            "64) and train_multichip --max-steps 4 under torchrun --nproc_per_node=1 (NCCL, a "
            "world of one) started together, then train_multichip --virtual 2 --max-steps 4 "
            "(two gloo processes sharing the card) ==")
        vout = os.path.join(tmp, "vaegan_out")
        # each multichip run in a folder of its own: a fresh run wipes its sample folder
        runs = [os.path.join(tmp, d) for d in ("virtual", "torchrun")]
        for d in runs:
            os.makedirs(d)
        commands = [
            ("train_vaegan", [sys.executable, "-m", "vaegan_tpu_torch.examples.train_vaegan",
                              "--epochs", "1", "--image-size", "96", "--batch-size", "64",
                              "--out", vout]),
            ("train_multichip --virtual 2", [
                sys.executable, "-m", "vaegan_tpu_torch.examples.train_multichip", "--virtual",
                "2", "--max-steps", "4"], runs[0]),
            ("torchrun train_multichip", [
                sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node=1", "-m", "vaegan_tpu_torch.examples.train_multichip",
                "--max-steps", "4"], runs[1]),
        ]
        # two waves: beside this process, the four at once ran out of the card's memory
        outs = run_together([commands[0], commands[2]], timeout=600)
        outs = [outs[0], *run_together(commands[1:2], timeout=600), outs[1]]
        last = outs[0].strip().splitlines()[-1]
        m = re.match(r"^artifacts in (.*)/ — recon MSE ([0-9.eE+-]+|nan|inf)$", last)
        pngs = {p: os.path.getsize(os.path.join(vout, p)) if os.path.isfile(os.path.join(vout, p))
                else 0 for p in ("reconstructions.png", "prior_samples.png", "interpolation.png")}
        log(f"14.2 train_vaegan: {last!r}; PNG bytes {pngs}")
        if not (m and finite([float(m.group(2))]) and all(pngs.values())):
            raise SystemExit("14.2 train_vaegan: no finite MSE or a PNG missing")
        for (label, *_), out, world in zip(commands[1:], outs[1:], (2, 1)):
            closing = [JOURNEY_CLOSING.match(l) for l in out.strip().splitlines()]
            closing = [c for c in closing if c]
            log(f"14.3 {label}: {closing[-1].group(0) if closing else '(no closing line)'} "
                f"[{card_line}]")
            if not (closing and closing[-1].groups()[:3] == ("4", str(world), str(world))
                    and finite([float(closing[-1].group(4))])):
                raise SystemExit(f"14.3 {label}: no closing line of 4 steps over {world}")
        log(f"phase 14: {time.perf_counter() - t14:.1f} s")
        return journey
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def hbm_ranks(tmp):
    """14.4 (run in a process of its own, beside 14.1's): :func:`hbm_rank` in
    two gloo processes; prints a ``14.4`` line and fails unless every batch
    of both ranks is bitwise the host loader's."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p))
    res = run_ranks("14.4 hbm_cache", 2, "hbm_rank", tmp, env)
    for r, got in enumerate(res):
        print(f"14.4 hbm_cache rank {r}: {got['equal']} of {got['batches']} batches of "
              f"{got['rows']} rows bitwise the rank-sharded host loader's (one epoch, "
              f"grad_accum 2, {got['staged_mib']} MiB staged on the card)", flush=True)
    if not all(got["batches"] > 0 and got["equal"] == got["batches"] for got in res):
        raise SystemExit("14.4: a rank's hbm_cache batches differ from the host loader's")


# ---------------------------------------------------------------------------
# phase 15: the research tools (vaegan_tpu_torch.tools), each in its own process
# ---------------------------------------------------------------------------
TOOL_STEPS = 20             # paper_probe's and gan_only_budget's steps
TOOL_EVAL_EVERY = 10        # their evals (and gan_only's grids) at steps 1, 10 and 20
TOOL_NIFTI_FILES = 24       # the dataset paper_probe reads, written by make_nifti_dataset
TOOL_LBR_STEPS = 4          # large_batch_recipe's steps (96², the penalty every step) at
TOOL_LBR_BATCH = 64         # batch 64 (cut from 128: it runs beside profile_step_residual's 128)
TOOL_PROFILE_STEPS = 2      # profile_step_residual's timed and traced steps
TOOL_EDGES_SIZE = 64        # edges_multiseed's runs: one epoch of 1200 images at 64²,
TOOL_EDGES_BATCH = 64       # batch 64 (18 steps a run)
# one gan_only G+D step (BCE with no penalty, so the critic is fused at its 7
# sites). Forwards: the generator's 12, the critic's 7 on the real and on the
# fake batch and 7 in the G half; backwards: 7 + 7 in the D half, 7 + 12 in the
# G half (through the critic into the generator)
GAN_ONLY_LAUNCHES = {"bn_act_dropout": 33, "bn_act_dropout_bwd": 33, "reparam_kl": 1,
                     "reparam_kl_bwd": 1, "recon_loss_sums": 1}
# eval-mode forwards, row 1 only: a reconstruct (the generator's 12 sites), the
# fused critic (7), and save_visual_evidence (reconstruct 12, sample 6,
# interpolate 18: two encodes and a decode)
RECONSTRUCT_BN, CRITIC_BN, VISUALS_BN = 12, 7, 36
# a tool, or a run a tool starts, with its kernel launches appended to a log
TOOL_COUNTING = ("import sys, chip_smoke\n"
                 "chip_smoke.counted_tool(sys.argv[1], sys.argv[2], sys.argv[3:])\n")
RANK_COUNTING = ("import sys, chip_smoke\n"
                 "chip_smoke.counted_rank(sys.argv[1], sys.argv[2:])\n")


def no_launches():
    return dict.fromkeys(STEP_LAUNCHES[True], 0)


def add_launches(*terms):
    """The sum of ``(count, launches)`` terms, kernel by kernel."""
    total = no_launches()
    for n, launches in terms:
        for k, v in launches.items():
            total[k] += n * v
    return total


def bn_only(n):
    return dict(no_launches(), bn_act_dropout=n)


def write_launches(log_path, record):
    import torch

    from vaegan_tpu_torch.ops import fused

    peak = None
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        peak = round(torch.cuda.max_memory_allocated() / 2 ** 30, 2)
    with open(log_path, "a") as f:
        f.write(json.dumps({**record, "launches": dict(fused.LAUNCHES), "peak_gib": peak}) + "\n")


def counted_tool(module, log_path, argv):
    """``main(argv)`` of ``module`` in this process, its kernel launches
    appended to ``log_path`` as one JSON line. The runs that a tool starts go
    through this function too: ``edges_multiseed``'s ``reproduce_headline``
    processes (whose ``train()`` alone is counted, as phase 14 counts it) and
    ``run_256dp_virtual_mesh``'s ranks (:func:`counted_rank`, one log a rank;
    the preset cut to phase 11.4's float32 global batch)."""
    import importlib

    from vaegan_tpu_torch.ops import fused

    mod = importlib.import_module(module)
    name = module.rsplit(".", 1)[-1]
    if name == "edges_multiseed":
        arm = mod.arm_command

        def counted_arm(vae, seed, args):
            cmd = arm(vae, seed, args)
            i = cmd.index("-m")
            return cmd[:i] + ["-c", TOOL_COUNTING, cmd[i + 1], log_path] + cmd[i + 2:]
        mod.arm_command = counted_arm
    elif name == "run_256dp_virtual_mesh":
        preset = mod.preset

        def cut(preset_name):
            cfg = preset(preset_name)
            return cfg.replace(data=cfg.data.replace(batch_size=DP_RANK_BATCH),
                               train=cfg.train.replace(dtype="float32"))
        mod.preset = cut
        rank = mod.rank_command
        mod.rank_command = lambda *a: ([sys.executable, "-c", RANK_COUNTING, log_path]
                                       + rank(*a)[3:])
    elif name == "reproduce_headline":
        train = mod.train

        def counted_train(cfg, **kw):
            fused.reset_launches()
            out = train(cfg, **kw)
            write_launches(log_path, {"run": name, "steps": out[0].step})
            return out
        mod.train = counted_train
        mod.main(argv)
        return
    fused.reset_launches()
    mod.main(argv)
    write_launches(log_path, {"run": name})


def counted_rank(log_path, argv):
    """A ``run_256dp_virtual_mesh`` rank (``rank_main(*argv)``), its launches
    written to ``<log_path>.rank<r>``."""
    from vaegan_tpu_torch.ops import fused
    from vaegan_tpu_torch.tools import run_256dp_virtual_mesh as mesh

    fused.reset_launches()
    mesh.rank_main(*argv)
    write_launches(f"{log_path}.rank{argv[0]}", {"run": f"rank {argv[0]}"})


def read_log(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def last_json(out):
    """The last JSON object of a tool's output: its last line, or an
    indented document that ends it."""
    lines = out.strip().splitlines()
    if lines and lines[-1].startswith("{"):
        return json.loads(lines[-1])
    start = out.rfind("\n{")
    return json.loads(out[start + 1:] if start >= 0 else out)


def tool_evals(steps, every):
    return sum(1 for s in range(1, steps + 1) if s % every == 0 or s == 1)


def tool_launches(edges_steps=(), steps=TOOL_STEPS, every=TOOL_EVAL_EVERY,
                  lbr_steps=TOOL_LBR_STEPS, profile_steps=TOOL_PROFILE_STEPS):
    """The kernel launches of each phase-15 tool run: its steps', its
    eval-mode forwards' (row 1 alone), its sample grids' (the sampler's
    train-mode forward) and its timing loops'. ``edges_steps``: the steps of
    each of edges_multiseed's runs, whose ``train()`` alone is counted;
    run_256dp_virtual_mesh's two ranks take 2 + 1 steps each and rank 0
    evaluates the live and the EMA iterate."""
    from vaegan_tpu_torch.tools import common

    forwards = 1 + common.TIMED_WARMUP + common.TIMED_REPS * common.TIMED_WINDOWS
    evals = tool_evals(steps, every)
    per_eval = 2 * RECONSTRUCT_BN + 2 * CRITIC_BN      # live and EMA, the critic twice
    return {
        "make_nifti_dataset": no_launches(),
        "conv_fusion_evidence": bn_only(2 * forwards),
        "paper_loss_fusion_evidence": no_launches(),
        "paper_loss_fusion_evidence --pallas": dict(no_launches(), reparam_kl=forwards,
                                                    reparam_kl_bwd=forwards),
        "gan_only_budget": add_launches((steps, GAN_ONLY_LAUNCHES), (evals, SAMPLER_LAUNCHES),
                                        (evals + 2, bn_only(RECONSTRUCT_BN))),
        "paper_probe": add_launches((steps, PAPER_LAUNCHES), (1, bn_only(
            evals * per_eval + 3 * (per_eval + RECONSTRUCT_BN) + VISUALS_BN))),
        "large_batch_recipe": add_launches((lbr_steps, STEP_LAUNCHES[True]),
                                           (3, bn_only(RECONSTRUCT_BN))),
        "edges_multiseed": add_launches(*(t for n in edges_steps for t in (
            (n, STEP_LAUNCHES[True]), (1, SAMPLER_LAUNCHES)))),
        "run_256dp_virtual_mesh": add_launches((2 * 3, DP_STEP_LAUNCHES[True]),
                                               (1, bn_only(2 * RECONSTRUCT_BN))),
        "profile_step_residual": add_launches((3 + 2 * profile_steps, STEP_LAUNCHES[True])),
    }


def phase_tools(torch, vt, card_line):
    """Phase 15: every research tool of ``vaegan_tpu_torch.tools`` on the card,
    each in its own process through :func:`counted_tool` (three waves of
    processes started together), each tool's output checked and its kernel
    launches held to what its path runs. Returns the launches by tool path."""
    import shutil

    from vaegan_tpu_torch.ops import fused
    from vaegan_tpu_torch.tools import make_nifti_dataset

    t15 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="vaegan_tools_")
    logs = {}

    def tool(label, name, *argv):
        logs[label] = os.path.join(tmp, f"{label.replace(' ', '_')}.launches")
        return (label, [sys.executable, "-c", TOOL_COUNTING, f"vaegan_tpu_torch.tools.{name}",
                        logs[label], *argv], tmp)

    nii, pallas = os.path.join(tmp, "nii"), ("--use-pallas", "all")
    try:
        log(f"== phase 15: the research tools (python -m vaegan_tpu_torch.tools.*), their "
            f"launches counted: make_nifti_dataset ({TOOL_NIFTI_FILES} files) in this process; "
            "then, each in its own process, wave 1: edges_multiseed (--seeds 1, one epoch at "
            f"{TOOL_EDGES_SIZE}², batch {TOOL_EDGES_BATCH}), paper_probe (the NIfTI files at "
            f"256², batch 4, {TOOL_STEPS} steps, --keep-best, EMA 0.999), "
            "conv_fusion_evidence and paper_loss_fusion_evidence (both at their defaults, "
            f"both modes), gan_only_budget ({TOOL_STEPS} steps, --keep-best), "
            f"run_256dp_virtual_mesh (2 gloo processes, global batch {DP_RANK_BATCH}, "
            f"float32); wave 2: large_batch_recipe ({TOOL_LBR_STEPS} steps, batch "
            f"{TOOL_LBR_BATCH}) and profile_step_residual (--steps {TOOL_PROFILE_STEPS}) ==")
        # make_nifti_dataset renders on the host and launches nothing: it runs
        # in this process, its launches the counts' difference
        before = dict(fused.LAUNCHES)
        nifti = make_nifti_dataset.main(["--out", nii, "--n", str(TOOL_NIFTI_FILES)])
        nifti_launches = {k: fused.LAUNCHES[k] - before[k] for k in before}
        wave1 = [
            tool("edges_multiseed", "edges_multiseed", "--seeds", "1", "--epochs", "1",
                 "--image-size", str(TOOL_EDGES_SIZE), "--batch-size", str(TOOL_EDGES_BATCH),
                 "--recalibrate-bn", "2", "--save-visuals-seed", "-1", "--out",
                 os.path.join(tmp, "edges"), *pallas),
            tool("paper_probe", "paper_probe", "--data-dir", nii, "--image-size", "256",
                 "--batch", "4", "--steps", str(TOOL_STEPS), "--eval-every",
                 str(TOOL_EVAL_EVERY), "--keep-best", "--ema-decay", "0.999",
                 "--save-visuals", os.path.join(tmp, "paper_vis"), *pallas),
            tool("conv_fusion_evidence", "conv_fusion_evidence", "--hlo",
                 os.path.join(tmp, "conv_ops.txt")),
            tool("paper_loss_fusion_evidence", "paper_loss_fusion_evidence"),
            tool("paper_loss_fusion_evidence --pallas", "paper_loss_fusion_evidence",
                 "--pallas"),
            tool("gan_only_budget", "gan_only_budget", "--steps", str(TOOL_STEPS),
                 "--eval-every", str(TOOL_EVAL_EVERY), "--grid-every", str(TOOL_EVAL_EVERY),
                 "--keep-best", "--out", os.path.join(tmp, "gan_only"), *pallas),
            tool("run_256dp_virtual_mesh", "run_256dp_virtual_mesh", "--devices", "2",
                 *pallas),
        ]
        # the two steps at 96² with the penalty at batch 128 would not fit together
        wave2 = [
            tool("large_batch_recipe", "large_batch_recipe", "--steps", str(TOOL_LBR_STEPS),
                 "--batch", str(TOOL_LBR_BATCH), "--log-every", "2", *pallas),
            tool("profile_step_residual", "profile_step_residual", "--steps",
                 str(TOOL_PROFILE_STEPS), *pallas),
        ]
        outs = {}
        for wave in (wave1, wave2):
            outs.update(zip((c[0] for c in wave), run_together(wave, timeout=600)))
        recs = {"make_nifti_dataset": nifti,
                **{label: last_json(out) for label, out in outs.items()}}
        counted = {label: read_log(path) for label, path in logs.items()}
        launches = {label: lines[-1]["launches"] for label, lines in counted.items()
                    if label not in ("edges_multiseed", "run_256dp_virtual_mesh")}
        launches["make_nifti_dataset"] = nifti_launches
        for label, rec in recs.items():
            log(f"15 {label}: {json.dumps(rec)[:1500]} [{card_line}]")

        files = sorted(os.listdir(nii))
        ok = {"make_nifti_dataset": (recs["make_nifti_dataset"]["n"] == TOOL_NIFTI_FILES
                                     and sum(f.endswith(".gz") for f in files)
                                     == TOOL_NIFTI_FILES // 3)}
        rec = recs["conv_fusion_evidence"]
        ok["conv_fusion_evidence"] = (
            rec["modes"]["all"]["kernel_calls"] == {"bn_act_dropout": 2}
            and not rec["modes"]["off"]["kernel_calls"]
            and finite([v for m in rec["modes"].values() for v in
                        (m["measured_bytes_MB"], m["ratio_vs_aggressive"], m["ms"])])
            and os.path.getsize(os.path.join(tmp, "conv_ops.txt")) > 0)
        for label, pallas_on in (("paper_loss_fusion_evidence", False),
                                 ("paper_loss_fusion_evidence --pallas", True)):
            rec = recs[label]
            ok[label] = (rec["kernel_calls"] == ({"reparam_kl": 1, "reparam_kl_bwd": 1}
                                                 if pallas_on else {})
                         and finite([rec["measured_bytes_MB"], rec["ratio_vs_aggressive"],
                                     rec["ms"]]))
        rec = recs["gan_only_budget"]
        out_dir = os.path.join(tmp, "gan_only")
        ok["gan_only_budget"] = (
            "keep_best" in rec and finite([rec["recon_proxy_last"], rec["keep_best"][
                "best_recon_proxy"], rec["loglog_fit"]["slope"]])
            and all(os.path.isfile(os.path.join(out_dir, f)) for f in (
                "curve.jsonl", "summary.json", "final_recon_panel.png", "best_recon_panel.png",
                *(f"samples_{s:06d}.png" for s in (1, TOOL_EVAL_EVERY, TOOL_STEPS)))))
        rec = recs["paper_probe"]
        ok["paper_probe"] = (
            len(rec.get("eval_mse_repeat_draws_best_iterate", [])) == 3
            and len(rec.get("eval_mse_repeat_draws_ema", [])) == 3
            and finite([*rec["eval_mse_repeat_draws"], *rec["eval_mse_repeat_draws_ema"],
                        *rec["eval_mse_repeat_draws_best_iterate"],
                        rec["eval_mse_mean_predictor_floor"]])
            and all(os.path.getsize(p) > 0 for p in rec["visuals"].values()))
        rec = recs["large_batch_recipe"]
        ok["large_batch_recipe"] = (len(rec["eval_mse_draws"]) == 3
                                    and finite(rec["eval_mse_draws"] + rec["tail_recon"]))
        rec = recs["edges_multiseed"]
        arms = [a for a in counted["edges_multiseed"] if a["run"] == "reproduce_headline"]
        launches["edges_multiseed"] = add_launches(*((1, a["launches"]) for a in arms))
        ok["edges_multiseed"] = (len(arms) == 2 and len(rec["pairs"]) == 1 and finite(
            [v for k, v in rec["pairs"][0].items() if k != "seed"]))
        rec = recs["run_256dp_virtual_mesh"]
        ranks = [read_log(f"{logs['run_256dp_virtual_mesh']}.rank{r}")[-1] for r in range(2)]
        launches["run_256dp_virtual_mesh"] = add_launches(*((1, r["launches"]) for r in ranks))
        ok["run_256dp_virtual_mesh"] = (rec["phase_b_resumed_to_step"] == 3 and finite(
            [rec["eval_mse_live"], rec["eval_mse_ema"], *rec["final_metrics"].values()]))
        rec = recs["profile_step_residual"]
        families = {f["op"] for f in rec["top_families"]}
        ok["profile_step_residual"] = (
            bool(rec["top_ops"]) and {f"vaegan_{k}" for k in STEP_LAUNCHES[True]} <= families
            and finite([rec["step_time_ms"], rec["kernels_ms_per_step"],
                        rec["device_busy_share"]]))
        want = tool_launches([a["steps"] for a in arms])

        peaks = {label: max(x["peak_gib"] or 0 for x in lines)
                 for label, lines in counted.items()}
        peaks["run_256dp_virtual_mesh"] = max(r["peak_gib"] or 0 for r in ranks)
        peaks["make_nifti_dataset"] = 0
        for label in recs:
            log(f"15 {label}: launches {launches[label]} (want {want[label]}); peak "
                f"{peaks[label]} GiB a process; checks {'pass' if ok[label] else 'FAIL'}")
        bad = [label for label in recs if not ok[label] or launches[label] != want[label]]
        if bad:
            raise SystemExit(f"phase 15: {bad}: a wrong record or wrong launches")
        log(f"phase 15: {time.perf_counter() - t15:.1f} s")
        return {f"tool {label}": v for label, v in launches.items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# the kernels' on/off default, measured (not part of main(): run as
# python3 -c "import chip_smoke; chip_smoke.onoff_times()")
# ---------------------------------------------------------------------------
PALLAS_MODES = ("off", "losses", "all")
ONOFF_ROUNDS = 5            # rounds of the modes in turn
COMPILE_CHILD = """
import json, sys, time
import torch
import chip_smoke as cs
import vaegan_tpu_torch as vt
torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
cfg = vt.preset("notebook")
cfg = cfg.replace(train=cfg.train.replace(use_pallas="off"))
state = vt.create_train_state(cfg, device="cuda", seed=cs.SEED)
x = torch.rand((cs.TRAIN_BATCH, 256, 256, 1), generator=torch.Generator().manual_seed(1)).cuda()
step = torch.compile(vt.make_train_step(cfg, True))
out = {}
try:
    t0 = time.perf_counter()
    step(state, x, 1)
    torch.cuda.synchronize()
    out["first_call_s"] = time.perf_counter() - t0
    times = []
    for i in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, x, 2 + i)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["ms"] = sorted(times)
except Exception as e:
    out["error"] = f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"
print("COMPILED " + json.dumps(out), flush=True)
"""


def spread(ms):
    """(median, min, max) of a list of milliseconds."""
    return (round(statistics.median(ms), 3), round(min(ms), 3), round(max(ms), 3))


def timed_in_turns(torch, runs, rounds=ONOFF_ROUNDS, per_round=2):
    """``{label: [ms, ...]}``: each of ``runs`` (``{label: fn(i)}``) timed
    ``per_round`` calls a round, host clock around each call and a
    synchronize, the labels in turn each round (one warm-up call each first)."""
    for fn in runs.values():
        fn(0)
    torch.cuda.synchronize()
    out = {k: [] for k in runs}
    i = 1
    for _ in range(rounds):
        for label, fn in runs.items():
            for _ in range(per_round):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn(i)
                torch.cuda.synchronize()
                out[label].append((time.perf_counter() - t0) * 1e3)
                i += 1
    return out


def onoff_times():
    """``use_pallas`` "off" / "losses" / "all" timed in turns on the notebook
    G+D step (256², float32) at batch 4 and 16, the ``vaegan_paper`` step (96²,
    batch 4), the ``vaegan_256_dp`` G+D step (bfloat16, remat on, global batch
    32, one process) and the batch-64 ``vaegan_infer`` reconstruct; then the
    notebook "off" step at batch 4 with ``cudnn.benchmark`` and with
    ``cudnn.deterministic`` against the defaults, and ``torch.compile`` of it
    (in a process of its own, its error recorded if it raises). Prints each
    median, min and max with the card's name and power limit, and an
    ``ONOFF`` JSON line."""
    import torch

    import vaegan_tpu_torch as vt

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    from vaegan_tpu_torch.ops import _build

    _build.build_all()
    result = {"card": card}
    gcpu = torch.Generator().manual_seed(1)

    def steps_of(name, batch, size, **train):
        cfg = vt.preset(name)
        cfg = cfg.replace(data=cfg.data.replace(image_size=size, batch_size=batch),
                          train=cfg.train.replace(**train))
        x = torch.rand((batch, size, size, 1), generator=gcpu).cuda()
        runs = {}
        for mode in PALLAS_MODES:
            c = cfg.replace(train=cfg.train.replace(use_pallas=mode))
            state = vt.create_train_state(c, device="cuda", seed=SEED)
            step = (vt.make_paper_train_step(c) if c.optim.scheme == "three"
                    else vt.make_train_step(c, True))
            runs[mode] = lambda i, step=step, state=state: step(state, x, 100 + i)
        return runs

    cases = (("notebook G+D step b4", ("notebook", 4, 256), {}),
             ("notebook G+D step b16", ("notebook", 16, 256), {}),
             ("vaegan_paper step b4", ("vaegan_paper", 4, 96), {}),
             ("vaegan_256_dp G+D step b32 (remat)", ("vaegan_256_dp", 32, 256), {"remat": True}))
    for label, args, train in cases:
        runs = steps_of(*args, **train)
        ms = timed_in_turns(torch, runs)
        result[label] = {k: spread(v) for k, v in ms.items()}
        log(f"{label}: " + "; ".join(f"{k} {v[0]} ms (min {v[1]}, max {v[2]})"
                                     for k, v in result[label].items()) + f" [{card}]")
        del runs
        torch.cuda.empty_cache()

    cfg = vt.preset("vaegan_infer")
    images = torch.rand((BATCH, cfg.data.image_size, cfg.data.image_size, 1),
                        generator=gcpu).cuda()
    runs = {}
    for mode in PALLAS_MODES:
        c = cfg.replace(train=cfg.train.replace(use_pallas=mode))
        st = vt.create_generator_state(c, device="cuda", seed=SEED)
        runs[mode] = lambda i, c=c, st=st: vt.reconstruct(c, st, images)
    label = f"vaegan_infer reconstruct b{BATCH}"
    result[label] = {k: spread(v) for k, v in timed_in_turns(torch, runs, per_round=4).items()}
    log(f"{label}: " + "; ".join(f"{k} {v[0]} ms (min {v[1]}, max {v[2]})"
                                 for k, v in result[label].items()) + f" [{card}]")
    del runs

    # cuDNN's flags on the default ("off") notebook step at batch 4
    off = steps_of("notebook", 4, 256)["off"]
    flags = {}
    for name, bench, det in (("defaults", False, False), ("cudnn.benchmark", True, False),
                             ("cudnn.deterministic", False, True), ("defaults again", False, False)):
        torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic = bench, det
        flags[name] = spread(timed_in_turns(torch, {name: off}, rounds=1, per_round=10)[name])
    torch.backends.cudnn.benchmark = torch.backends.cudnn.deterministic = False
    result["notebook off step b4 by cuDNN flags"] = flags
    log("notebook off step b4 by cuDNN flags: " + "; ".join(
        f"{k} {v[0]} ms (min {v[1]}, max {v[2]})" for k, v in flags.items()) + f" [{card}]")
    del off
    torch.cuda.empty_cache()

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p))
    try:
        proc = subprocess.run([sys.executable, "-c", COMPILE_CHILD], cwd=HERE, env=env,
                              capture_output=True, text=True, timeout=600)
        line = next((l for l in proc.stdout.splitlines() if l.startswith("COMPILED ")), None)
        compiled = (json.loads(line[len("COMPILED "):]) if line else
                    {"error": f"rc {proc.returncode}: {proc.stderr.strip()[-300:]}"})
    except subprocess.TimeoutExpired:
        compiled = {"error": "no result within 600 s"}
    if "ms" in compiled:
        compiled["ms"] = spread(compiled["ms"])
    result["torch.compile of the notebook off step b4"] = compiled
    log(f"torch.compile of the notebook off step b4: {json.dumps(compiled)} [{card}]")
    log("ONOFF " + json.dumps(result))


KERNEL_TIMES = """
import importlib.util, json, os, subprocess, sys
import torch
spec = importlib.util.spec_from_file_location("chip_smoke", os.environ["CHIP_SMOKE"])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
import vaegan_tpu_torch as vt
from vaegan_tpu_torch.ops import _build

kind = torch.cuda.get_device_name(0)
props = torch.cuda.get_device_properties(0)
clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                       capture_output=True, text=True, check=True).stdout.split()[0]
libs = _build.build_all()
counts, _ = cs.kernel_counts(libs, os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump"))
bounds = cs.Bounds(cs.card_bandwidth(kind),
                   props.multi_processor_count * cs.LANES_PER_SM * float(clock) * 1e6, counts)
torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
cfg = vt.preset("vaegan_infer")
gen = vt.create_generator_state(cfg.replace(train=cfg.train.replace(use_pallas="all")),
                                device="cuda", seed=cs.SEED).generator
sites = cs.fused_sites(torch, gen, cfg.data.image_size, cfg.generator.in_channels)
latent = vt.latent_shape(cfg)
pick = lambda d: {k: {f: v[f] for f in ("ms", "bound_ms", "issue_ms", "instr_ms") if f in v}
                  for k, v in d.items()}
out = {"instructions": {" ".join(str(a) for a in k if a is not None): v for k, v in counts.items()},
       "training": pick(cs.phase_train_kernels(torch, sites, latent, bounds)),
       "dp": pick(cs.phase_dp_kernels(torch, sites, latent, bounds, 32)),
       "stripe": pick(cs.phase_stripe_kernels(torch, sites, latent, bounds))}
print("PAIR " + json.dumps(out), flush=True)
"""


def paired_kernels(trees, timeout=900):
    """Rows 1-5's kernel, bound and SASS issue milliseconds at the training, DP
    and stripe sites, and each kernel instance's hot-loop instructions per
    element (:func:`kernel_counts`), for each checkout in ``trees`` in turn, each
    with its own package and build and this script's phases and timing
    (:data:`KERNEL_TIMES`): give a parent's tree and this one as parent, this,
    this, parent to compare two versions on one card. Prints each tree's log
    and then one ``PAIR`` line for it."""
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    for tree in trees:
        root = os.path.abspath(tree)
        env = dict(os.environ, PYTHONPATH=root, CHIP_SMOKE=os.path.join(HERE, "chip_smoke.py"))
        proc = subprocess.run([sys.executable, "-c", KERNEL_TIMES], cwd=root, env=env,
                              capture_output=True, text=True, timeout=timeout)
        lines = proc.stdout.splitlines()
        line = [x for x in lines if x.startswith("PAIR ")]
        if proc.returncode or not line:
            sys.exit(f"{tree}: rc {proc.returncode}\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        for x in lines:
            if not x.startswith("PAIR "):
                log(f"[{tree}] {x}")
        log(f"PAIR {os.path.relpath(root, HERE)} [{smi}] {line[0][5:]}")


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
                    args += [v for tag, v in (("Li4E", "4"), ("Li1E", "1")) if tag in name]
                    bits = re.findall(r"Lb(\d)E", name.split(short)[1].split("EEv")[0])
                    args += [flag if bit == "1" else f"no {flag}"
                             for flag, bit in zip(KERNEL_FLAGS.get(short, ()), bits)]
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
    log(f"bounds: data-sheet memory rate {bw / 1e12:.2f} TB/s and float32 rate "
        f"{OPS_RATE / 1e12:.0f} TFLOP/s over each kernel's bytes and algorithm's operations; "
        f"beside them the SASS issue time at {sms} SMs x {LANES_PER_SM} lanes x {clock} MHz "
        f"(max SM clock) = {instr_rate / 1e12:.2f} T instructions/s, over each kernel's "
        "hot-loop instructions per element")
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
    weights_equal = bundle_weights_equal(torch, gen, bundle)
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
    del cfg_train, train_state, batches
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- phase 8
    t = time.perf_counter()
    loop_launches = phase_loop(torch, vt, card_line, t4)
    log(f"phase 8: {time.perf_counter() - t:.1f} s")

    # ---------------------------------------------------------------- phase 9
    t = time.perf_counter()
    paper = phase_paper(torch, vt, bounds, card_line, tf32_defaults)
    log(f"phase 9: {time.perf_counter() - t:.1f} s")

    # ---------------------------------------------------------------- phase 10
    t = time.perf_counter()
    concat = phase_concat(torch, vt, bounds, card_line, paper["sites"])
    log(f"phase 10.1: {time.perf_counter() - t:.1f} s")
    cli_launches = phase_cli(torch, vt, card_line)
    log(f"phase 10.1-10.2: {time.perf_counter() - t:.1f} s")
    phase_bench(torch, vt, card_line)
    log(f"phase 10: {time.perf_counter() - t:.1f} s")

    # ---------------------------------------------------------------- phase 11
    t = time.perf_counter()
    dp = phase_dp(torch, vt, bounds, card_line, sites, vt.latent_shape(cfg))
    log(f"phase 11: {time.perf_counter() - t:.1f} s")

    # ---------------------------------------------------------------- phase 12
    t = time.perf_counter()
    mesh = phase_mesh(torch, vt, bounds, card_line, sites, vt.latent_shape(cfg))
    log(f"phase 12: {time.perf_counter() - t:.1f} s")

    # ---------------------------------------------------------------- phase 13
    t13 = time.perf_counter()
    roofline = phase_roofline(torch, vt, card_line)
    bundle_launches = phase_bundle(torch, vt, cfg_all, state, images, z8, t64, t1, card_line)
    log(f"phase 13: {time.perf_counter() - t13:.1f} s")

    # ---------------------------------------------------------------- phase 14
    journey = phase_journeys(torch, vt, card_line)

    # ---------------------------------------------------------------- phase 15
    tools = phase_tools(torch, vt, card_line)
    log(f"summary [{card_line}]: serving reconstruct b{BATCH} {BATCH / t64:.1f} images/s; "
        f"training step b{TRAIN_BATCH} {t4 * 1e3:.3f} ms = {TRAIN_BATCH / t4:.2f} images/s, "
        f"b16 {t16 * 1e3:.3f} ms = {16 / t16:.2f} images/s; paper step b{TRAIN_BATCH} "
        f"{paper['step_s'] * 1e3:.3f} ms = {TRAIN_BATCH / paper['step_s']:.2f} images/s; "
        "notebook G+D step by critic batching: " + ", ".join(
            f"{k} {v[0] * 1e3:.3f} ms" for k, v in concat["numbers"].items())
        + f"; paper concat step {concat['paper_s'] * 1e3:.3f} ms; vaegan_256_dp G+D step at "
        f"global batch {dp['batch']} with remat {dp['step_s'] * 1e3:.3f} ms = "
        f"{dp['batch'] / dp['step_s']:.2f} images/s; 2 x 2 mesh (4 gloo processes, float32, "
        f"batch {DP_RANK_BATCH}) step wall by process "
        f"{[[round(t * 1e3, 1) for t in r] for r in mesh['mesh']['step_s']]} ms; TP-only loop "
        f"step ({MESH_MODEL} gloo processes, bfloat16, batch {TP_BATCH}) "
        f"{[round(t * 1e3, 1) for t in mesh['tp_step_s']]} ms; roofline (bench --roofline, "
        "96x96, batch 128, bfloat16, kernels on): " + "; ".join(
            f"{r['label']} {r['step_ms']} ms, {r['fraction_of_achieved_bw']} of the triad's "
            f"{r['achieved_hbm_gbs_triad']} GB/s" for r in roofline))

    # launches: the data-parallel path's (phase 11: train_data_parallel of
    # vaegan_256_dp, all five kernels); each other path's launches (the notebook
    # loop of phase 8, the paper loop of phase 9, the notebook's accumulating
    # step, phase 12's tensor-parallel loop and CLI, one process's count, and
    # phase 15's tool paths) stand beside them, with row 1's serving figures,
    # rows 1-2's figures at the
    # critic's sites, rows 1-4's at the DP step's shapes with an index base
    # ("dp") and on a stripe of them ("stripe")
    src = "vaegan_tpu_torch/csrc/"
    paths = {"paper": paper["paper"], "accum": paper["accum"], **concat["paths"],
             "cli_train": cli_launches, "loop": loop_launches, "dp": dp["launches"],
             "cli_train_dp": dp["cli_launches"], "tp_loop": mesh["tp_launches"],
             "cli_train_dp_tp": mesh["cli_launches"], "journey": journey, **tools}

    def critic_figures(row, run=paper["critic"]):
        c = run[row]
        return {"sites": c["sites"], "ms": c["ms"], "plain_ms": c["plain_ms"],
                "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                "max_abs_err": c["max_abs_err"]}

    train_row1 = train_kernels["bn_act_dropout"]
    rows = [{
        "name": "bn_act_dropout", "route": "cuda", "source": src + "bn_act_dropout.cu",
        "replaces": "vaegan_tpu/ops/pallas_fused.py:80",
        "launches": dp["launches"]["bn_act_dropout"],
        "launches_by_path": {"serving": main_path_launches, "bundle": bundle_launches,
                             "training": train_launches["bn_act_dropout"],
                             **{k: v["bn_act_dropout"] for k, v in paths.items()}},
        "dp": dp["kernels"]["bn_act_dropout"],
        "critic_sites": critic_figures("bn_act_dropout"),
        "critic_sites_concat": critic_figures("bn_act_dropout", concat["critic"]),
        "ms_by_path": {"serving": summary["ms"], "training": train_row1["ms"]},
        "bound_by_path": {"serving": summary["bound_ms"], "training": train_row1["bound_ms"]},
        "max_abs_err": summary["max_abs_err"], "ms": train_row1["ms"],
        "plain_ms": train_row1["plain_ms"], "bound_ms": train_row1["bound_ms"],
        "bound_by": train_row1["bound_by"], "library_ms": None,
        "bound_bytes_ms": train_row1["bytes_ms"], "sass_issue_ms": train_row1["instr_ms"],
    }]
    for name, source, line in (("bn_act_dropout_bwd", "bn_act_dropout.cu", 95),
                               ("reparam_kl", "reparam_kl.cu", 244),
                               ("reparam_kl_bwd", "reparam_kl.cu", 262),
                               ("recon_loss_sums", "recon_loss_sums.cu", 373)):
        k = train_kernels[name]
        rows.append({"name": name, "route": "cuda", "source": src + source,
                     "replaces": f"vaegan_tpu/ops/pallas_fused.py:{line}",
                     "launches": dp["launches"][name],
                     "launches_by_path": {"training": train_launches[name],
                                          **{k: v[name] for k, v in paths.items()}},
                     "max_abs_err": k["max_abs_err"],
                     "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"], "library_ms": k["library_ms"],
                     "bound_bytes_ms": k["bytes_ms"], "sass_issue_ms": k["instr_ms"]})
    for row in rows:
        row["launches_by_path"].update({f"roofline {r['label']}": r["launches"][row["name"]]
                                        for r in roofline})
    for row in rows[1:4]:
        row["dp"] = dp["kernels"][row["name"]]
    for row in rows[:4]:
        row["stripe"] = mesh["kernels"][row["name"]]
    # the least any one-launch kernel on row 5's grid takes: an empty kernel's time
    rows[-1]["launch_floor_ms"] = train_kernels["recon_loss_sums"]["floor_ms"]
    rows[1]["critic_sites"] = critic_figures("bn_act_dropout_bwd")
    rows[1]["critic_sites_concat"] = critic_figures("bn_act_dropout_bwd", concat["critic"])
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
