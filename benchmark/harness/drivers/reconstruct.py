"""Traffic kind ``reconstruct``: a closed loop of one client calling the port's
``inference.reconstruct`` (evaluation mode, the served path) on batches of the
images the benchmark makes, each call timed from its issue to its
synchronised result.

The batch rows of every call come from a seeded stream (``batch`` distinct
images of ``images`` per call). The weights are drawn from the seed, the BN
statistics included. Set-up makes the model and the images and runs
``warmup_calls`` calls of the window's shape; a sample of ``compared_calls``
of the window's first ``sample_from`` calls, drawn from the seed, keeps its
outputs for the comparison.

The spans: ``reconstruct`` (inside the call, before the wait), ``client`` (the
rest of each call's turn).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from harness import compare, inputs
from harness.drivers import common
from harness.trace import Spans
from reference import model as rm
from reference import serve as rs

KIND = "reconstruct"


class Driver:
    def __init__(self, cell, seed: int, device, traced: bool = False,
                 fault: Optional[str] = None):
        from vaegan_tpu_torch.config import Config
        self.cell, self.seed, self.device, self.traced = cell, seed, torch.device(device), traced
        t = cell.traffic
        base = Config.from_dict(cell.config["config"])
        self.cfg = base.replace(data=base.data.replace(batch_size=int(t["batch"])))
        self.cfg_dict = self.cfg.to_dict()
        self.fault = fault
        self.spans = Spans(traced)
        self.run = common.Run(kind=KIND, dtype=self.cfg.train.dtype,
                              batch=self.cfg.data.batch_size, spans=self.spans)
        rng = np.random.default_rng(inputs.derive(seed, "sample"))
        self.keep = set(int(i) for i in rng.choice(int(t["sample_from"]),
                                                   int(t["compared_calls"]), replace=False))
        self.kept: Dict[int, tuple] = {}

    def weights(self):
        return inputs.make_weights(rm.generator_spec(self.cfg_dict), self.seed, self.device,
                                   "served generator", random_norms=True)

    def rows(self, i: int) -> np.ndarray:
        """The image rows of call ``i`` (negative: a warm-up call)."""
        t = self.cell.traffic
        rng = np.random.default_rng([inputs.derive(self.seed, "requests"), i + (1 << 20)])
        return rng.choice(int(t["images"]), int(t["batch"]), replace=False)

    def make_images(self) -> torch.Tensor:
        return inputs.make_images(int(self.cell.traffic["images"]), self.cfg.data.image_size,
                                  self.seed, self.device)

    def batch(self, i: int) -> torch.Tensor:
        return self.images[torch.as_tensor(self.rows(i), device=self.device)]

    def setup(self) -> None:
        from vaegan_tpu_torch import inference
        from vaegan_tpu_torch.train.state import create_generator_state

        self.images = self.make_images()
        state = create_generator_state(self.cfg, device=self.device)
        inputs.load_into(state.generator, *self.weights())
        self.state, self.reconstruct = state, inference.reconstruct
        for i in range(-int(self.cell.traffic.get("warmup_calls", 2)), 0):
            self.call(i)
        common.sync(self.device)

    def call(self, i: int):
        batch = self.batch(i)
        with self.spans("client"):
            t0 = time.perf_counter()
            with self.spans("reconstruct"):
                if self.fault == "half":
                    recon, mse = self.reconstruct(self.cfg, self.state,
                                                  batch[: batch.shape[0] // 2])
                    recon = torch.cat([recon, recon])
                else:
                    recon, mse = self.reconstruct(self.cfg, self.state, batch)
                if self.fault == "altered":
                    recon = recon.clone()
                    recon[0] += 0.5
            common.sync(self.device)
            t1 = time.perf_counter()
        return recon, mse, t1 - t0

    def window(self, seconds: float) -> common.Run:
        run = self.run
        self.spans.records.clear()
        with common.traced_window(self.traced, run.launches) as prof:
            t0 = time.perf_counter()
            i = 0
            while time.perf_counter() < t0 + seconds:
                recon, mse, lat = self.call(i)
                run.latencies.append(lat)
                if i in self.keep:
                    self.kept[i] = (recon, mse)
                i += 1
            t1 = time.perf_counter()
        run.window_s, run.ops = t1 - t0, i
        run.extra.update(t0=t0, t1=t1)
        if prof is not None:
            from harness import trace, yardstick
            run.trace = trace.reduce(prof, "client")
            run.flops_per_op = yardstick.reconstruct_flops(self.cfg_dict, run.batch)
        return run

    def release(self) -> None:
        self.kept = {i: (r.detach().float().cpu(), float(m)) for i, (r, m) in self.kept.items()}
        for k in ("state", "reconstruct"):
            self.__dict__.pop(k, None)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def checks(self) -> Dict[str, object]:
        params, buffers = self.weights()
        progs: List[dict] = []
        refs: List[dict] = []
        for i in sorted(self.kept):
            recon, mse = rs.reconstruct(self.cfg_dict, params, buffers, self.batch(i))
            refs.append({"recon": recon.cpu(), "mse": mse})
            progs.append({"recon": self.kept[i][0], "mse": self.kept[i][1]})
        if not progs:
            raise RuntimeError("the window made none of the sampled calls")
        return compare.serve_checks(progs, refs)
