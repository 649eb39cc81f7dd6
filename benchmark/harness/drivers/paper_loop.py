"""Traffic kind ``paper_loop``: the port's training journey, ``train()``, with
the step functions it builds for a three-optimizer configuration
(``optim.scheme == "three"``): Larsen et al.'s Algorithm 1,
``make_paper_train_step``. Everything else is ``train_loop``'s: the feed, the
window, the spans and the comparison, here against ``reference.paper``. Its
runs are training-loop runs and report the kind ``train_loop``, which the
``.train`` metrics read."""

from __future__ import annotations

import sys
import time
from typing import Dict, List

from harness import inputs
from harness.drivers import common
from harness.drivers import train_loop as tl
from reference import draws as rd
from reference import paper as rp
from reference import train as rt


class Driver(tl.Driver):
    def setup(self) -> None:
        from vaegan_tpu_torch.data.pipeline import DeviceDataLoader
        from vaegan_tpu_torch.train import train
        from vaegan_tpu_torch.train.state import create_train_state
        from vaegan_tpu_torch.train.step import make_paper_train_step
        from vaegan_tpu_torch.utils.metrics import MetricsLogger, StdoutSink

        cfg = self.cfg
        if cfg.optim.scheme != "three":
            raise ValueError("paper_loop runs a three-optimizer configuration")
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
        loader = DeviceDataLoader(tl._Images(self.images().cpu().numpy()),
                                  batch_size=cfg.data.batch_size, shuffle=True,
                                  drop_last=False, seed=inputs.derive(self.seed, "loader"),
                                  device=self.device)
        mark("feed")
        self.feed = tl._Feed(loader, self.spans)
        # the step functions train() builds for optim.scheme == "three"
        self.steps = tl._Steps({(True, True): make_paper_train_step(cfg)}, self.spans,
                               self.fault)
        self.logger = MetricsLogger(sinks=[StdoutSink(sys.stderr)], flush_every=cfg.train.log_every)
        self.train = train
        self.state, self.logger = train(
            cfg.replace(train=cfg.train.replace(max_steps=self.compared)), loader=self.feed,
            state=state, logger=self.logger, step_fns=self.steps.wrapped(), device=self.device)
        mark("compared_steps")
        parts["snapshots"] = self.steps.snap_s
        self.steps.recording = False

    def window(self, seconds: float) -> common.Run:
        # the window is train_loop's; its operation count is Algorithm 1's
        from harness import yardstick
        counted = yardstick.train_step_flops
        yardstick.train_step_flops = rp.step_flops
        try:
            return super().window(seconds)
        finally:
            yardstick.train_step_flops = counted

    def reference_steps(self, starts, batches, precision: str = "fp32",
                        first: int = 0) -> List[Dict[str, object]]:
        """The reference's step ``first + k`` from ``starts[k]`` on ``batches[k]``."""
        out = []
        for k, (s, b) in enumerate(zip(starts, batches), start=first):
            dev = self.device
            st = rt.State(*(common.to_device(s[n], dev) for n in ("gp", "gb", "dp", "db")),
                          common.to_device(s["g_sq"], dev), common.to_device(s["d_sq"], dev),
                          None if s["ema"] is None else common.to_device(s["ema"], dev))
            r = rp.step(self.cfg_dict, st, b, rd.step_seed(self.cfg.train.seed, k), precision)
            out.append(tl.ref_snapshot(r))
            del st, r
        return out
