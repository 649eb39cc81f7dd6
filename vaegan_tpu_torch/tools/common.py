"""What the tools share: the flags the port adds to the JAX scripts', a
dataset staged on the device with batches gathered there, the eval-mode MSE,
and the best iterate kept on the device (``--keep-best``)."""

from __future__ import annotations

import argparse
import copy
from typing import Dict, Optional

import numpy as np
import torch

from vaegan_tpu_torch import inference
from vaegan_tpu_torch.config import Config
from vaegan_tpu_torch.models import UnsupervisedGeneratorNetwork


def parser(doc: str) -> argparse.ArgumentParser:
    """A tool's parser: ``--help`` shows each flag's default."""
    return argparse.ArgumentParser(description=doc.splitlines()[0],
                                   formatter_class=argparse.ArgumentDefaultsHelpFormatter)


def show_defaults(ap: argparse.ArgumentParser) -> argparse.ArgumentParser:
    """Give each flag without a help text one that shows its default (the
    formatter shows defaults only beside a help text)."""
    for action in ap._actions:
        if action.option_strings and action.help is None:
            action.help = "default: %(default)s"
    return ap


def add_device(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda, which raises without a card; "
                         "cpu runs on the CPU)")


def add_use_pallas(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--use-pallas", default=None, choices=["off", "losses", "all"],
                    help="override TrainConfig.use_pallas (the fused CUDA kernels; "
                         "default: the preset's)")


def train_overrides(args) -> dict:
    """``TrainConfig`` fields the port's flags set: ``use_pallas`` when given."""
    return {} if args.use_pallas is None else {"use_pallas": args.use_pallas}


def stage(dataset, n: int, device: torch.device) -> torch.Tensor:
    """Images ``0..n-1`` of ``dataset`` as one (n, H, W, C) float32 tensor on
    ``device``, copied once."""
    return torch.as_tensor(dataset.load_batch(range(n))).to(device)


def gather(data: torch.Tensor, idx) -> torch.Tensor:
    """The rows ``idx`` (host indices, numpy) of the staged ``data``, gathered
    on its device."""
    return data.index_select(0, torch.as_tensor(np.asarray(idx), dtype=torch.long,
                                                device=data.device))


# a timed call: CUDA events around TIMED_REPS calls, the median of TIMED_WINDOWS
# such windows, after TIMED_WARMUP calls
TIMED_WARMUP, TIMED_REPS, TIMED_WINDOWS = 3, 20, 5


def cuda_ms(fn) -> float:
    """Median milliseconds a call of ``fn(i)`` over CUDA-event windows (the
    module's constants)."""
    for i in range(TIMED_WARMUP):
        fn(i)
    times = []
    for _ in range(TIMED_WINDOWS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for i in range(TIMED_REPS):
            fn(i)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / TIMED_REPS)
    return sorted(times)[len(times) // 2]


def eval_mse(cfg: Config, gen: UnsupervisedGeneratorNetwork, batch: torch.Tensor) -> float:
    """The reference's one-batch MSE of ``gen`` in eval mode."""
    return float(inference.eval_reconstruct(cfg, gen, batch)[1])


class KeepBest:
    """The best-scoring iterate so far, kept on its device.

    A port step updates its parameters, buffers and EMA in place, so a
    snapshot of references or ``state_dict()`` views would follow the next
    step; :meth:`offer` copies every tensor it keeps (``detach().clone()``):
    the parameters (or the EMA given in their place) and every buffer (the BN
    running statistics)."""

    def __init__(self):
        self.score: Optional[float] = None
        self.step: Optional[int] = None
        self.params: Dict[str, torch.Tensor] = {}
        self.buffers: Dict[str, torch.Tensor] = {}

    def offer(self, score: float, step: int, gen: UnsupervisedGeneratorNetwork,
              params: Optional[Dict[str, torch.Tensor]] = None) -> bool:
        """Keep ``params`` (default: ``gen``'s own) and ``gen``'s buffers when
        ``score`` is lower than the kept one's. Returns whether it kept them."""
        if self.score is not None and not score < self.score:
            return False
        src = dict(gen.named_parameters()) if params is None else params
        self.params = {k: v.detach().clone() for k, v in src.items()}
        self.buffers = {k: b.detach().clone() for k, b in gen.named_buffers()}
        self.score, self.step = score, step
        return True

    def generator(self, like: UnsupervisedGeneratorNetwork) -> UnsupervisedGeneratorNetwork:
        """A copy of ``like`` that holds the kept iterate."""
        gen = copy.deepcopy(like)
        with torch.no_grad():
            for k, p in gen.named_parameters():
                p.copy_(self.params[k])
            for k, b in gen.named_buffers():
                b.copy_(self.buffers[k])
        return gen
