"""The benchmark's own tests (CPU, tiny sizes): ``python -m pytest benchmark/tests``.

Tests that need the card carry the ``card`` marker and skip without one."""

import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def tiny(cell, image_size: int = 16):
    """``cell`` at a size the CPU runs in seconds: the widths cut, the images
    cut, fewer images and sampled calls."""
    c = copy.deepcopy(cell)
    cf = c.config["config"]
    cf["data"]["image_size"] = image_size
    cf["generator"]["feature_size"] = 8
    cf["discriminator"].update(num_features_conv1=8, num_features_res=[8, 16, 16],
                               linear_widths=[16, 8])
    if c.traffic["kind"] == "train_loop":
        c.traffic = dict(c.traffic, images=48, batch=4)
    else:
        c.traffic = dict(c.traffic, images=48, batch=8, sample_from=6, compared_calls=3)
    return c


@pytest.fixture(scope="session")
def bench():
    import torch
    torch.set_num_threads(1)
    from harness import spec
    return spec.load_benchmark()
