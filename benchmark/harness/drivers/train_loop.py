"""Traffic kind ``train_loop``: the port's training journey, ``train()``, fed by
``DeviceDataLoader`` (the ``hbm_cache`` path) over images the benchmark makes.

Set-up builds the train state (the port's ``create_train_state``, then the benchmark's
weights), the loader and the port's step functions, and drives them through
``train()`` for the first ``compared_steps`` steps, recording the program's
state after each; the same objects then run the window, ``train()`` again,
until ``--seconds`` have passed (a step due after that raises, so the window
ends on a whole step). The traffic file gives the batch, the number of images
and the metric flush cadence.

The spans: ``feed`` (inside the loader's ``next()``), ``step`` (inside the step
call); the rest of the window is the loop's.
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from harness import compare, inputs
from harness.drivers import common
from harness.trace import Spans
from reference import draws as rd
from reference import model as rm
from reference import train as rt

KIND = "train_loop"
SAMPLE_DIR = "benchmark/_work/samples"


class WindowOver(Exception):
    """A step came due after the window's end."""


class _Images:
    """A dataset of images held on the host, as the loader reads one."""

    def __init__(self, a: np.ndarray):
        self.a = a

    def __len__(self) -> int:
        return len(self.a)

    def load_batch(self, indices) -> np.ndarray:
        return self.a[np.asarray(indices)]


class _Feed:
    """The loader, with a span around each ``next()``."""

    def __init__(self, loader, spans: Spans):
        self.loader, self.spans = loader, spans

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            with self.spans("feed"):
                b = next(it, None)
            if b is None:
                return
            yield b


def _square_avg(opt, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Each parameter's RMSprop square average (zeros before its first update)."""
    return {k: opt.state.get(p, {}).get("square_avg", torch.zeros_like(p))
            for k, p in params.items()}


def snapshot(state, batch, metrics) -> Dict[str, object]:
    """The program's state after a step, on the host, through one copy."""
    gen, critic = state.generator, state.critic
    gp, dp = dict(gen.named_parameters()), dict(critic.named_parameters())
    losses = {k: torch.as_tensor(v, device=batch.device) for k, v in metrics.items()}
    groups = {"batch": {"batch": batch}, "losses": losses,
              "gp": gp, "gb": dict(gen.named_buffers()),
              "dp": dp, "db": dict(critic.named_buffers()),
              "g_sq": _square_avg(state.opt_g, gp), "d_sq": _square_avg(state.opt_d, dp),
              "ema": state.g_ema or {}}
    host = common.to_host_all(groups)
    host["batch"] = host["batch"]["batch"]
    host["losses"] = {k: float(v) for k, v in host["losses"].items()}
    if state.g_ema is None:
        host["ema"] = None
    return host


class _Steps:
    """The port's step functions, called through a span; in set-up each
    step's resulting state is recorded; in the window a step due after the
    deadline raises. ``fault`` breaks the timed path for the tests of the
    comparison: ``"unchanged"`` returns the state as it came, ``"half"`` steps
    on the first half of the batch, ``"lr2"`` runs both optimizers at twice
    their learning rate."""

    def __init__(self, fns: dict, spans: Spans, fault: Optional[str] = None):
        self.fns, self.spans, self.fault = fns, spans, fault
        self.recording = True
        self.snaps: List[Dict[str, object]] = []
        self.deadline: Optional[float] = None
        self.done = 0
        self.snap_s = 0.0

    def wrapped(self) -> dict:
        return {key: (lambda state, batch, seed, key=key: self(key, state, batch, seed))
                for key in self.fns}

    def __call__(self, key, state, batch, seed):
        if self.deadline is not None and time.perf_counter() >= self.deadline:
            raise WindowOver
        if self.fault == "lr2" and not self.done and not self.snaps:
            for opt in (state.opt_g, state.opt_d):
                for group in opt.param_groups:
                    group["lr"] *= 2.0
        with self.spans("step"):
            if self.fault == "unchanged":
                out = state, {k: torch.zeros((), device=batch.device)
                              for k in ("d_loss", "g_loss")}
            elif self.fault == "half":
                out = self.fns[key](state, batch[: batch.shape[0] // 2], seed)
            else:
                out = self.fns[key](state, batch, seed)
        if self.recording:
            t = time.perf_counter()
            self.snaps.append(snapshot(state, batch, out[1]))
            self.snap_s += time.perf_counter() - t
        else:
            self.done += 1
        return out


class Driver:
    def __init__(self, cell, seed: int, device, traced: bool = False,
                 fault: Optional[str] = None):
        from vaegan_tpu_torch.config import Config
        self.cell, self.seed, self.device, self.traced = cell, seed, torch.device(device), traced
        t = cell.traffic
        base = Config.from_dict(cell.config["config"])
        self.cfg = base.replace(
            data=base.data.replace(batch_size=int(t["batch"]), hbm_cache=True),
            train=base.train.replace(seed=inputs.derive(seed, "steps") & 0xFFFFFFFF,
                                     n_epochs=1 << 30, max_steps=None, sample_interval=0,
                                     sample_dir=SAMPLE_DIR, checkpoint_dir=None,
                                     log_every=int(t.get("log_every", 1))))
        self.cfg_dict = self.cfg.to_dict()
        self.compared = int(t.get("compared_steps", 3))
        self.spans = Spans(traced)
        self.fault = fault
        self.run = common.Run(kind=KIND, dtype=self.cfg.train.dtype,
                              batch=self.cfg.data.batch_size, spans=self.spans)

    # ---- the benchmark's inputs ------------------------------------------------
    def initial(self):
        """The weights the benchmark makes: generator and critic parameters and
        buffers."""
        gp, gb = inputs.make_weights(rm.generator_spec(self.cfg_dict), self.seed, self.device,
                                     "generator")
        dp, db = inputs.make_weights(rm.critic_spec(self.cfg_dict), self.seed, self.device,
                                     "critic")
        return gp, gb, dp, db

    def images(self) -> torch.Tensor:
        return inputs.make_images(int(self.cell.traffic["images"]), self.cfg.data.image_size,
                                  self.seed, self.device)

    # ---- the program -----------------------------------------------------------
    def setup(self) -> None:
        from vaegan_tpu_torch.data.pipeline import DeviceDataLoader
        from vaegan_tpu_torch.train import train
        from vaegan_tpu_torch.train.state import create_train_state
        from vaegan_tpu_torch.train.step import make_step_variants, make_train_step
        from vaegan_tpu_torch.utils.metrics import MetricsLogger, StdoutSink

        cfg = self.cfg
        parts, t = self.run.extra.setdefault("setup_parts", {}), [time.perf_counter()]

        def mark(name):
            common.sync(self.device)
            t.append(time.perf_counter())
            parts[name] = t[-1] - t[-2]

        state = create_train_state(cfg, device=self.device)
        mark("state")
        gp, gb, dp, db = self.initial()
        inputs.load_into(state.generator, gp, gb)
        inputs.load_into(state.critic, dp, db)
        if state.g_ema is not None:
            state.g_ema = {k: v.detach().clone() for k, v in state.generator.named_parameters()}
        del gp, gb, dp, db
        mark("weights")
        loader = DeviceDataLoader(_Images(self.images().cpu().numpy()),
                                  batch_size=cfg.data.batch_size, shuffle=True,
                                  drop_last=False, seed=inputs.derive(self.seed, "loader"),
                                  device=self.device)
        mark("feed")
        self.feed = _Feed(loader, self.spans)
        self.steps = _Steps(make_step_variants(cfg, lambda do_g, do_gp, scale: make_train_step(
            cfg, do_g, do_gp=do_gp, gp_lambda_scale=scale)), self.spans, self.fault)
        self.logger = MetricsLogger(sinks=[StdoutSink(sys.stderr)], flush_every=cfg.train.log_every)
        self.train = train
        self.state, self.logger = train(
            cfg.replace(train=cfg.train.replace(max_steps=self.compared)), loader=self.feed,
            state=state, logger=self.logger, step_fns=self.steps.wrapped(), device=self.device)
        mark("compared_steps")
        parts["snapshots"] = self.steps.snap_s
        self.steps.recording = False

    def window(self, seconds: float) -> common.Run:
        run, spans = self.run, self.spans
        spans.records.clear()
        with common.traced_window(self.traced, run.launches) as prof:
            t0 = time.perf_counter()
            self.steps.deadline = t0 + seconds
            try:
                self.state, _ = self.train(self.cfg, loader=self.feed, state=self.state,
                                           logger=self.logger, step_fns=self.steps.wrapped(),
                                           device=self.device)
            except WindowOver:
                pass
            common.sync(self.device)
            t1 = time.perf_counter()
        run.window_s, run.ops = t1 - t0, self.steps.done
        run.extra.update(t0=t0, t1=t1)
        if prof is not None:
            from harness import trace, yardstick
            run.trace = trace.reduce(prof, "loop")
            run.flops_per_op = yardstick.train_step_flops(self.cfg_dict, run.batch)
        return run

    def release(self) -> None:
        """Drop every object of the program, so the reference has the card."""
        snaps = self.steps.snaps
        for k in ("state", "feed", "steps", "logger", "train"):
            self.__dict__.pop(k, None)
        self.snaps = snaps
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- the reference ---------------------------------------------------------
    def ref_batches(self, images: torch.Tensor, n: int) -> List[torch.Tensor]:
        """The first ``n`` batches the loader's seed gives."""
        it = rd.epoch_batches(images.shape[0], self.cfg.data.batch_size,
                              inputs.derive(self.seed, "loader"))
        return [images[torch.as_tensor(next(it), device=images.device)] for _ in range(n)]

    def start(self) -> Dict[str, object]:
        gp, gb, dp, db = self.initial()
        ema = None if self.cfg.train.ema_decay is None else dict(gp)
        return {"gp": gp, "gb": gb, "dp": dp, "db": db, "g_sq": {}, "d_sq": {}, "ema": ema}

    def reference_steps(self, starts, batches, precision: str = "fp32",
                        first: int = 0) -> List[Dict[str, object]]:
        """The reference's step ``first + k`` from ``starts[k]`` on ``batches[k]``."""
        out = []
        for k, (s, b) in enumerate(zip(starts, batches), start=first):
            dev = self.device
            st = rt.State(*(common.to_device(s[n], dev) for n in ("gp", "gb", "dp", "db")),
                          common.to_device(s["g_sq"], dev), common.to_device(s["d_sq"], dev),
                          None if s["ema"] is None else common.to_device(s["ema"], dev))
            r = rt.step(self.cfg_dict, st, b, rd.step_seed(self.cfg.train.seed, k), precision)
            out.append(ref_snapshot(r))
            del st, r
        return out

    def checks(self) -> Dict[str, object]:
        """The readings of the program's compared steps."""
        images = self.images()
        batches = self.ref_batches(images, len(self.snaps))
        start = {k: (v if v is None or not isinstance(v, dict) else common.to_host(v))
                 for k, v in self.start().items()}
        starts = [start] + self.snaps[:-1]
        refs = self.reference_steps(starts, batches)
        return compare.train_checks(self.cfg_dict, starts, self.snaps, refs, batches)


def ref_snapshot(r: rt.StepOut) -> Dict[str, object]:
    s = r.state
    return {"losses": {k: float(v) for k, v in r.losses.items()},
            "g_grads": common.to_host(r.g_grads), "d_grads": common.to_host(r.d_grads),
            "gp": common.to_host(s.gp), "gb": common.to_host(s.gb),
            "dp": common.to_host(s.dp), "db": common.to_host(s.db),
            "g_sq": common.to_host(s.g_sq), "d_sq": common.to_host(s.d_sq),
            "ema": None if s.ema is None else common.to_host(s.ema)}
