"""Name where a train step's device time goes (the port of
``tools/profile_step_residual.py``).

Traces ``--steps`` executions of the configured step on the device with
``torch.profiler`` and ranks the device time of its kernels two ways: by
kernel name (``top_ops``) and by family (``top_families``): cuDNN
convolutions (forward, dgrad, wgrad, a backward's whose name does not say
which, and those under a double-backward node: the gradient penalty's),
GEMMs, copies, reductions, elementwise, other, and each of the port's five
kernels by its ``fused.LAUNCHES`` name (``vaegan_bn_act_dropout`` ...). A
kernel's family comes from its name and from the ops that launched it (the
profiler hands each op the device events it launched, and the op knows the
ops around it). The step time comes from CUDA events around
the same number of steps without the profiler, and the traced window's from
CUDA events around the traced steps; beside them the device's busy share (the
union of the kernels' intervals over the traced window).

The step's own spans (``utils.profiling``: ``step.g_forward``,
``step.d_backward``, ...) are in the trace as ``vaegan.*`` ranges, and two
tables read them: ``by_span``, each span's device time a step (the union of
the intervals of the kernels it launched: a kernel belongs to the innermost
``vaegan.*`` span among the ancestors of what launched it (the op it links
to, or, where the profiler gives no such link, the CUDA call that shares its
id), or, for a launch on the autograd engine's own thread, whose ancestors
stop there, to the innermost one open on any thread when it began), and
``idle_gaps``, the
longest gaps between the kernels, each labelled with the innermost
``vaegan.*`` span open on the host when it began.

    python -m vaegan_tpu_torch.tools.profile_step_residual                 # notebook G+D step
    python -m vaegan_tpu_torch.tools.profile_step_residual --gp-every 4    # lazy-GP off-step
    python -m vaegan_tpu_torch.tools.profile_step_residual --vae | --paper # the other steps

Prints one JSON document. The JAX script's keys are kept where they mean the
same thing; the XLA-only ones are renamed: ``xla_ops_ms_per_step`` (HLO op
time) is ``kernels_ms_per_step`` (the kernels' device time summed),
``async_copy_ms_per_step_overlapped`` is ``busy_ms_per_step`` (the union of
the kernels' intervals, so overlap counts once), and each op's ``out`` (its
HLO output shape, which a kernel name does not carry) is ``launches`` (a
step's). ``traced_step_time_ms`` and ``device_busy_share`` are added. A
profile with no device event is taken again, up to ``PROFILE_ATTEMPTS``
times, and then the run fails: it never prints an empty table. The JAX
script's warm-up of a full step before a critic-only one works round a TPU
runtime quirk and is not needed here. The flags are the JAX script's, with
its defaults, plus ``--device`` (a CUDA device: the profile is the card's)
and ``--use-pallas``.
"""

from __future__ import annotations

import argparse
import json
import re
from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

import torch

from vaegan_tpu_torch.config import Config, preset
from vaegan_tpu_torch.ops.conv import InputGrad
from vaegan_tpu_torch.tools.common import (
    add_device,
    add_use_pallas,
    parser,
    show_defaults,
    train_overrides,
)
from vaegan_tpu_torch.train import create_train_state, make_paper_train_step, make_train_step
from vaegan_tpu_torch.train.state import resolve_device
from vaegan_tpu_torch.train.step import step_seed
from vaegan_tpu_torch.utils import profiling

# profiles taken before the run gives up on an empty one
PROFILE_ATTEMPTS = 4
WARMUP_STEPS = 3
# the port's kernels by their device function's name
PORT_KERNELS = {"bn_act_dropout_fwd_kernel": "bn_act_dropout",
                "bn_act_dropout_bwd_kernel": "bn_act_dropout_bwd",
                "reparam_fwd_kernel": "reparam_kl", "reparam_bwd_kernel": "reparam_kl_bwd",
                "recon_sums_kernel": "recon_loss_sums"}
# a cuDNN convolution kernel's name; its direction is in the name (wgrad,
# dgrad) or else in the ops that launched it (module docstring)
CONV = re.compile(r"wgrad|dgrad|fprop|implicit_convolve|convolve_|conv2d|_conv_|"
                  r"cudnn::.*conv", re.I)
# (family, pattern) of the other kernels, in the order tried
FAMILIES = (
    ("gemm", re.compile(r"gemm|gemv|cublas|cutlass|xmma|matmul", re.I)),
    ("copy", re.compile(r"copy|memcpy|memset|transpose|nchwToNhwc|nhwcToNchw|CatArray|"
                        r"index|gather|scatter", re.I)),
    ("reduction", re.compile(r"reduce|welford|batch_norm|norm_|softmax|sum_", re.I)),
    ("elementwise", re.compile(r"elementwise|pointwise|Functor|kernel_impl|vectorized|"
                               r"unrolled", re.I)),
)
OP_NAME_CHARS = 200
# the backward nodes that run the penalty's double backward through a
# convolution: autograd's own rule (``ConvolutionBackwardBackward0``) and the
# port's for ``Conv2D``'s input gradient (``ops.conv.InputGrad``)
DOUBLE_BWD_NODES = ("backwardbackward", f"{InputGrad.__name__}Backward".lower())


def build_parser() -> argparse.ArgumentParser:
    ap = parser(__doc__)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--image-size", type=int, default=96)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--vae", action="store_true")
    ap.add_argument("--paper", action="store_true")
    ap.add_argument("--critic-only", action="store_true")
    ap.add_argument("--gp-every", type=int, default=1,
                    help=">1 profiles the lazy-GP off-step (no grad-of-grad)")
    add_use_pallas(ap)
    add_device(ap)
    return show_defaults(ap)


def preset_name(args) -> str:
    return "vaegan_paper" if args.paper else "notebook_vae" if args.vae else "notebook"


def build_config(args) -> Config:
    cfg = preset(preset_name(args))
    return cfg.replace(
        data=cfg.data.replace(image_size=args.image_size, batch_size=args.batch),
        train=cfg.train.replace(dtype=args.dtype, **train_overrides(args)))


def label_of(args) -> str:
    label = {"notebook": "WGAN-GP", "vaegan_paper": "Larsen-paper",
             "notebook_vae": "plain-VAE"}[preset_name(args)]
    if args.critic_only:
        label += " critic-only"
    if args.gp_every > 1:
        label += " no-GP off-step"
    return label


def build_step(cfg: Config, args, dev: torch.device):
    """``(step, state, batch)`` of the configured step, as the JAX script
    builds them (state seed 0, a uniform batch from seed 1)."""
    state = create_train_state(cfg, device=dev, seed=0)
    if cfg.optim.scheme == "three":
        step = make_paper_train_step(cfg)
    else:
        step = make_train_step(cfg, do_g_update=not args.critic_only, do_gp=args.gp_every <= 1)
    batch = torch.rand((args.batch, args.image_size, args.image_size, 1),
                       generator=torch.Generator().manual_seed(1)).to(dev)
    return step, state, batch


def family(name: str, context: str = "") -> str:
    """The family of a device kernel, by its name and ``context``: the op that
    launched it and the ops around that one (module docstring). A
    convolution under a double-backward node (the gradient penalty's:
    :data:`DOUBLE_BWD_NODES`) is ``cudnn_conv_double_bwd``; else the name's
    wgrad or dgrad; else one under a backward node, whose name does not say
    which of the two it computes, ``cudnn_conv_bwd``; else ``cudnn_conv_fwd``."""
    for fn, launch_name in PORT_KERNELS.items():
        if fn in name:
            return f"vaegan_{launch_name}"
    if CONV.search(name):
        lower, ctx = name.lower(), context.lower()
        if any(node in ctx for node in DOUBLE_BWD_NODES):
            return "cudnn_conv_double_bwd"
        if "wgrad" in lower:
            return "cudnn_conv_wgrad"
        if "dgrad" in lower:
            return "cudnn_conv_dgrad"
        return "cudnn_conv_bwd" if "backward" in ctx else "cudnn_conv_fwd"
    for fam, pattern in FAMILIES:
        if pattern.search(name):
            return fam
    return "other"


def merged(intervals: Iterable[Tuple[float, float]]) -> List[List[float]]:
    """The (start, end) intervals merged where they overlap, in order."""
    busy: List[List[float]] = []
    for a, b in sorted(intervals):
        if busy and a <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], b)
        else:
            busy.append([a, b])
    return busy


def union_ms(intervals: Iterable[Tuple[float, float]]) -> float:
    """Milliseconds covered by at least one of the (start, end) microsecond
    intervals (a sum would count overlapping kernels twice)."""
    return sum(b - a for a, b in merged(intervals)) / 1e3


def reduce_profile(kernels: Sequence[Tuple[str, float, int, str]],
                   intervals: Sequence[Tuple[float, float]], steps: int, window_ms: float,
                   top: int) -> Dict[str, object]:
    """The tables of a traced window: ``kernels`` holds device kernels'
    (name, device microseconds, launches, the ops that launched them)
    over ``steps`` steps, ``intervals`` every device event's (start, end) in
    microseconds, and ``window_ms`` the traced window's time.
    ``pct_of_step_time`` is a share of the window, ``pct_of_kernel_time`` of
    the kernels' times summed; the two differ where kernels overlap
    (``kernel_overlap``: the sum over the union of their intervals)."""
    per_name: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    per_family: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for name, us, count, context in kernels:
        for table, key in ((per_name, name), (per_family, family(name, context))):
            table[key][0] += us
            table[key][1] += count
    total_us = sum(v[0] for v in per_name.values())
    busy = union_ms(intervals)

    def rows(table, key):
        ranked = sorted(table.items(), key=lambda kv: -kv[1][0])[:top]
        return [{"op": n[:OP_NAME_CHARS] if key == "op" else n,
                 **({"launches": round(c / steps, 2)} if key == "op" else {}),
                 "ms_total": round(us / 1e3, 2),
                 "pct_of_step_time": round(100.0 * us / 1e3 / window_ms, 1),
                 "pct_of_kernel_time": round(100.0 * us / total_us, 1)}
                for n, (us, c) in ranked]

    return {"traced_step_time_ms": round(window_ms / steps, 1),
            "kernels_ms_per_step": round(total_us / 1e3 / steps, 1),
            "busy_ms_per_step": round(busy / steps, 1),
            "device_busy_share": round(busy / window_ms, 3),
            "kernel_overlap": round(total_us / 1e3 / busy, 2),
            "top_ops": rows(per_name, "op"),
            "top_families": rows(per_family, "family")}


def open_at(spans: Sequence[Tuple[str, float, float]], t: float) -> str:
    """The innermost (latest begun) of ``spans`` (name, start, end) open at
    ``t``, "" for none."""
    open_ = [(s, n) for n, s, e in spans if s <= t < e]
    return max(open_)[1] if open_ else ""


def span_of(op, spans: Sequence[Tuple[str, float, float]]) -> str:
    """The program span an op ran under (module docstring)."""
    p = op
    while p is not None:
        if p.name.startswith(profiling.PREFIX):
            return p.name
        p = p.cpu_parent
    return open_at(spans, op.time_range.start)


def span_tables(owners: Sequence[Tuple[str, float, float]],
                spans: Sequence[Tuple[str, float, float]], steps: int, window_ms: float,
                top: int) -> Dict[str, object]:
    """``by_span`` and ``idle_gaps`` (module docstring) of the device events
    ``owners`` (span name or "", start, end in microseconds) and the host's
    program ``spans`` (name, start, end)."""
    per: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    for name, a, b in owners:
        per[name or "(no span)"].append((a, b))
    ms = {name: union_ms(iv) for name, iv in per.items()}
    by_span = [{"span": name, "ms_per_step": round(v / steps, 2),
                "pct_of_step_time": round(100.0 * v / window_ms, 1)}
               for name, v in sorted(ms.items(), key=lambda kv: -kv[1])]
    busy = merged((a, b) for _, a, b in owners)
    gaps = sorted(((open_at(spans, x[1]) or "(no span)", (y[0] - x[1]) / 1e3)
                   for x, y in zip(busy, busy[1:]) if y[0] > x[1]), key=lambda g: -g[1])
    return {"by_span": by_span,
            "idle_gaps": [{"span": n, "ms": round(g, 3)} for n, g in gaps[:top]]}


def attribute(events, device, cpu) -> List[Tuple[str, float, int, str]]:
    """(name, device microseconds, launches, context) of the ``device`` events
    of a trace: the profiler hands each op (an event of type ``cpu``) the
    device events it launched (its ``kernels``, matched by correlation id),
    and those carry the op's :func:`context_of`; what no op launched is
    listed by name with an empty context."""
    kernels: List[Tuple[str, float, int, str]] = []
    linked: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.device_type == cpu and getattr(e, "kernels", None):
            context = context_of(e)
            for k in e.kernels:
                kernels.append((k.name, k.duration, 1, context))
                linked[k.name][0] += k.duration
                linked[k.name][1] += 1
    total: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    for e in device:
        total[e.name][0] += e.time_range.end - e.time_range.start
        total[e.name][1] += 1
    for name, (us, n) in total.items():
        if n > linked[name][1]:
            kernels.append((name, max(us - linked[name][0], 0.0), n - linked[name][1], ""))
    return kernels


def context_of(op, depth: int = 64) -> str:
    """The names of ``op`` (a profiler event) and of the ops around it,
    innermost first ("" for none)."""
    names = []
    while op is not None and len(names) < depth:
        names.append(op.name)
        op = op.cpu_parent
    return " < ".join(names)


def timed_steps(step, state, batch, seeds) -> float:
    """Milliseconds of ``step`` over ``seeds``, from CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for s in seeds:
        step(state, batch, s)
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def traced(step, state, batch, steps: int):
    """A torch.profiler trace of ``steps`` steps: (kernels, window ms,
    owners, spans): :func:`attribute`'s kernels, the window, every device
    event's (program span or "", start, end) and the program's host spans
    (name, start, end); taken again while it holds no device event. The
    spans' device-side ranges are not device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            window = timed_steps(step, state, batch,
                                 [step_seed(2, 100 + i) for i in range(steps)])
        events = prof.events()
        device = [e for e in events if e.device_type == DeviceType.CUDA
                  and e.time_range.end > e.time_range.start
                  and not e.name.startswith(profiling.PREFIX)]
        if device:
            spans = [(e.name, e.time_range.start, e.time_range.end) for e in events
                     if e.device_type == DeviceType.CPU and e.name.startswith(profiling.PREFIX)]
            # what launched a device event: the op it links to, where the
            # profiler gives that link, else the CUDA call that shares its id
            cpu = [e for e in events if e.device_type == DeviceType.CPU]
            ops = {e.id: e for e in cpu if not getattr(e, "linked_correlation_id", 0)}
            calls = {e.id: e for e in cpu if e.name.startswith("cu")}
            owners = []
            for e in device:
                link = getattr(e, "linked_correlation_id", 0)
                op = ops.get(link) if link else calls.get(e.id)
                owners.append((span_of(op, spans) if op is not None else "",
                               e.time_range.start, e.time_range.end))
            return attribute(events, device, DeviceType.CPU), window, owners, spans
        print(f"torch.profiler recorded no device event over {steps} steps "
              f"(profile {attempt} of {PROFILE_ATTEMPTS})", flush=True)
    raise SystemExit(f"torch.profiler recorded no device event in {PROFILE_ATTEMPTS} profiles")


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    cfg = build_config(args)
    dev = resolve_device(args.device)
    if dev.type != "cuda":
        raise SystemExit("profile_step_residual profiles a CUDA device: pass --device cuda")
    step, state, batch = build_step(cfg, args, dev)
    # warm up outside the trace (cuDNN picks its algorithms on the first calls)
    for i in range(WARMUP_STEPS):
        step(state, batch, step_seed(2, i))
    step_ms = timed_steps(step, state, batch,
                          [step_seed(2, 50 + i) for i in range(args.steps)]) / args.steps
    kernels, window, owners, spans = traced(step, state, batch, args.steps)
    intervals = [(a, b) for _, a, b in owners]
    record = {
        "step": label_of(args),
        "operating_point": f"{args.image_size}^2 batch {args.batch} {args.dtype}, "
                           f"use_pallas={cfg.train.use_pallas}",
        "device": torch.cuda.get_device_name(dev),
        "traced_steps": args.steps,
        "step_time_ms": round(step_ms, 1),
        **reduce_profile(kernels, intervals, args.steps, window, args.top),
        **span_tables(owners, spans, args.steps, window, args.top),
    }
    print(json.dumps(record, indent=1), flush=True)
    return record


if __name__ == "__main__":
    main()
