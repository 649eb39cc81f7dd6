#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``vaegan_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. environment: the card, its power limit, torch/CUDA versions; builds the CUDA
   kernel from ``vaegan_tpu_torch/csrc`` and prints the compiler's report.
   TF32 is switched off for convolutions and matmuls for the parity phases;
   the port's float32 convolutions pin IEEE float32 themselves, so phase 3
   repeats its model comparisons with PyTorch's default flags restored, and
   phase 4 times the default path users get;
2. kernel against its plain PyTorch version: ``bn_act_dropout`` at each of the
   served model's fused-BN sites at batch 64, float32 and bfloat16, dropout
   p = 0 and 0.5, timed with CUDA events beside its memory bound;
3. the served model: ``preset("vaegan_infer")`` (the notebook generator, 256²,
   float32, full width) with ``use_pallas="all"`` and seeded random weights
   answers reconstruct / encode / decode / sample / interpolate requests through
   the port's entry points and a serving bundle; the launch counts show every
   fused BN went through the kernel; the outputs are held against the
   ``use_pallas="off"`` model on the card and the CPU model on a small batch;
4. numbers: reconstruct images/s at batch 64, batch-1 latency, sample images/s.

The second-to-last line is a JSON object describing each kernel; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Data-sheet peaks (dense): HBM bytes/s and float32 (non-tensor-core) FLOP/s.
CARD_PEAKS = {
    "H100 PCIe": (2.0e12, 51.2e12),
    "H100": (3.35e12, 66.9e12),      # SXM5 80 GB
}

SEED = 0
BATCH = 64
SLOPE = 0.01
# f32 ops per element of the fused pass: subtract, multiply, add, LeakyReLU multiply
FLOPS_PER_ELEMENT = 4


def log(*a):
    print(*a, flush=True)


def card_peaks(name: str):
    for key, peaks in CARD_PEAKS.items():
        if key in name:
            return peaks
    raise SystemExit(f"chip_smoke: no data-sheet peaks for card {name!r}")


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


def l2_rotation(torch, x):
    """Copies of ``x`` to cycle through so that back-to-back timed launches find
    their input in device memory, not in the 50 MB L2, as the bound assumes."""
    n = max(1, -(-256 * 2 ** 20 // (x.numel() * x.element_size())))
    return [x] + [x.clone(memory_format=torch.channels_last) for _ in range(n - 1)]


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


def phase_kernel(torch, sites, bw, fp32_peak):
    from vaegan_tpu_torch.ops import fused

    log("== phase 2: bn_act_dropout kernel vs its plain version "
        f"(batch {BATCH}; kernel: median of 5 CUDA-event windows of 20 back-to-back "
        "launches after 3 warm-up; plain: one window of 20 calls; tolerance f32 "
        "|kernel - plain| <= 1e-6 + 1e-6 |plain|, bf16 <= 1 bf16 ulp of plain) ==")
    g = torch.Generator(device="cuda").manual_seed(SEED)
    summary = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "two_call_ms": 0.0,
               "bound_by": "bytes", "max_abs_err": 0.0}
    sums = {}   # (dtype, p) -> [kernel ms, plain ms, bound ms] summed over the sites
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
                if dtype == torch.float32:
                    bad = err > 1e-6 + 1e-6 * rf.abs()
                else:
                    bad = err > bf16_ulp(torch, rf)
                n_bad = int(bad.sum())
                masks_equal = True
                if p > 0:
                    keep = fused.keep_mask(x, seed, p)
                    masks_equal = (int(((yf != 0) & ~keep).sum()) == 0
                                   and int(((yf == 0) != (rf == 0)).sum()) == 0)
                    kept = float(keep.float().mean())
                    if not 0.45 <= kept <= 0.55:
                        raise SystemExit(f"site {i}: keep rate {kept} outside [0.45, 0.55]")
                xs = l2_rotation(torch, x)
                rest = args[1:]
                k_ms = time_cuda(torch, lambda i: fused.bn_act_dropout(xs[i % len(xs)], *rest))
                p_ms = time_cuda(torch, lambda i: fused.bn_act_dropout_reference(
                    xs[i % len(xs)], *rest), windows=1, warmup=1)
                numel = x.numel()
                nbytes = 2 * numel * x.element_size() + 4 * c * 4
                flops = (FLOPS_PER_ELEMENT + (1 if p > 0 else 0)) * numel
                b_ms = max(nbytes / bw, flops / fp32_peak) * 1e3
                bound_by = "bytes" if nbytes / bw >= flops / fp32_peak else "operations"
                log(f"site {i:2d} C={c:3d} HxW={h}x{w} {str(dtype)[6:]:8s} p={p}: "
                    f"max_abs_err={float(err.max()):.3e} out_of_tol={n_bad} "
                    f"masks_equal={masks_equal} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
                    f"bound_ms={b_ms:.4f} ({bound_by}) GB/s={nbytes / k_ms / 1e6:.0f}")
                if n_bad or not masks_equal:
                    raise SystemExit(f"site {i}: kernel disagrees with its plain version")
                acc = sums.setdefault((str(dtype)[6:], p), [0.0, 0.0, 0.0])
                for j, v in enumerate((k_ms, p_ms, b_ms)):
                    acc[j] += v
                if dtype == torch.float32:
                    summary["max_abs_err"] = max(summary["max_abs_err"], float(err.max()))
                if dtype == torch.float32 and p == 0.0:
                    summary["ms"] += k_ms
                    summary["plain_ms"] += p_ms
                    summary["bound_ms"] += b_ms
                    if bound_by != "bytes":
                        summary["bound_by"] = "operations"
                del y, r, yf, rf, err, bad, xs
        xs = l2_rotation(torch, x32)
        two = time_cuda(torch, lambda i: torch.nn.functional.leaky_relu(
            torch.nn.functional.batch_norm(xs[i % len(xs)], mean, var, scale, bias, False, 0.0,
                                           1e-5), SLOPE), windows=1, warmup=1)
        del xs
        summary["two_call_ms"] += two
        del x32
        torch.cuda.empty_cache()
    for (dt, p), (k, pl, b) in sums.items():
        log(f"sum over the {len(sites)} sites, {dt} p={p}: kernel {k:.4f} ms, plain {pl:.4f} ms, "
            f"bound {b:.4f} ms ({100 * b / k:.1f}% of the bound reached)")
    log(f"bn_act_dropout over the {len(sites)} sites of one batch-{BATCH} reconstruct (f32, p=0): "
        f"kernel {summary['ms']:.4f} ms, bound {summary['bound_ms']:.4f} ms, plain "
        f"{summary['plain_ms']:.4f} ms; F.leaky_relu(F.batch_norm(...)) as two PyTorch calls "
        f"{summary['two_call_ms']:.4f} ms (yardstick only, not one library call)")
    return summary


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
    bw, fp32_peak = card_peaks(kind)
    log(f"data-sheet peaks used for bounds: {bw / 1e12:.2f} TB/s, {fp32_peak / 1e12:.1f} TFLOP/s f32")
    tf32_defaults = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("TF32 off for cuDNN convolutions and matmuls for the parity phases (PyTorch's "
        f"defaults: cudnn.allow_tf32={tf32_defaults[0]}, matmul.allow_tf32={tf32_defaults[1]}, "
        "restored for the repeat of phase 3's model comparisons and for phase 4)")
    t0 = time.perf_counter()
    lib = _build.build("bn_act_dropout")
    log(f"kernel build: {time.perf_counter() - t0:.2f} s -> {os.path.relpath(lib, HERE)}")
    with open(f"{lib}.log") as f:
        report = f.read().strip()
    if report:
        log(report)

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
    summary = phase_kernel(torch, sites, bw, fp32_peak)

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
    gen_off = vt.build_models(cfg_off, device="cuda")
    gen_off.load_state_dict(gen.state_dict(), strict=True)
    state_off = state.replace(generator=gen_off)
    gen_cpu = vt.build_models(cfg_all, device="cpu")
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

    log(json.dumps({"kernels": [{
        "name": "bn_act_dropout",
        "route": "cuda",
        "source": "vaegan_tpu_torch/csrc/bn_act_dropout.cu",
        "replaces": "vaegan_tpu/ops/pallas_fused.py:80",
        "launches": main_path_launches,
        "max_abs_err": summary["max_abs_err"],
        "ms": summary["ms"],
        "plain_ms": summary["plain_ms"],
        "bound_ms": summary["bound_ms"],
        "bound_by": summary["bound_by"],
        "library_ms": None,
    }]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
