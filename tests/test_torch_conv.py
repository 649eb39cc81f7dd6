"""The port's phase-decomposed transposed convolution (``vaegan_tpu_torch.ops.conv``)
against the JAX package's (``vaegan_tpu.ops.conv`` with its
``PHASE_DECOMPOSE_CONV_TRANSPOSE`` set, as ``tests/test_torch_parity.py`` sets
it) and against the port's dilated path (``F.conv_transpose2d``): forward at
odd and even H/W in float32 and bfloat16, gradients with respect to x and w,
an upsample layer on two stripes against one, and a small generator.

Tolerances, relative to the reference's largest magnitude: float32 1e-5 (the
phase path regroups each output's sum of at most 4 C taps); bfloat16 2 ulps
(2**-7: both sides round their sums to bfloat16 once, in different orders); a
generator 1e-4 abs/rel, as ``tests/test_torch_generator.py``.
"""

from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vaegan_tpu.config import preset as jpreset
from vaegan_tpu.ops import conv as jconv
from vaegan_tpu.train.state import build_models as jbuild_models
import vaegan_tpu_torch as vt
from vaegan_tpu_torch.models.layers import Conv2D
from vaegan_tpu_torch.ops import conv
from vaegan_tpu_torch.ops.replica import Replica

torch.set_num_threads(1)

DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2 * 2.0 ** -7)}


@pytest.fixture
def phase(monkeypatch):
    """The flag on in both packages for the test's duration."""
    monkeypatch.setattr(conv, "PHASE_DECOMPOSE_CONV_TRANSPOSE", True)
    monkeypatch.setattr(jconv, "PHASE_DECOMPOSE_CONV_TRANSPOSE", True)


def inputs(h, w, cin=6, cout=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, h, w, cin)).astype(np.float32)               # NHWC
    k = rng.normal(size=(cin, cout, 4, 4)).astype(np.float32)            # (I, O, kH, kW)
    b = rng.normal(size=(cout,)).astype(np.float32)
    return x, k, b


def port_x(x, dtype=torch.float32):
    return torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype)            # channels_last


def close(got, want, rel, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max_abs_err {err:.3e} > {rel:g} x {scale:.3e}"


def test_the_flag_is_off_by_default_and_then_is_conv_transpose2d():
    assert conv.PHASE_DECOMPOSE_CONV_TRANSPOSE is False
    assert jconv.PHASE_DECOMPOSE_CONV_TRANSPOSE is False
    x, k, b = inputs(5, 6)
    xt, kt, bt = port_x(x), torch.from_numpy(k), torch.from_numpy(b)
    assert torch.equal(conv.conv_transpose2d(xt, kt, bt),
                       F.conv_transpose2d(xt, kt, bt, stride=2, padding=1))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,w", [(5, 6), (8, 8), (7, 3)])
def test_phase_path_matches_jax_phase_path(phase, h, w, dtype):
    tdt, jdt, rel = DTYPES[dtype]
    x, k, b = inputs(h, w)
    # the JAX kernel is HWIO in the forward orientation: (I, O, kH, kW) -> (kH, kW, I, O)
    want = jconv.conv_transpose2d(jnp.asarray(x, jdt), jnp.asarray(k.transpose(2, 3, 0, 1), jdt),
                                  2, 1) + jnp.asarray(b, jdt)
    got = conv.conv_transpose2d(port_x(x, tdt), torch.from_numpy(k).to(tdt),
                                torch.from_numpy(b).to(tdt))
    assert got.shape == (2, 8, 2 * h, 2 * w)
    assert got.is_contiguous(memory_format=torch.channels_last)
    close(got.float().permute(0, 2, 3, 1).numpy(), jnp.asarray(want, jnp.float32), rel,
          f"{dtype} {h}x{w}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("h,w", [(5, 6), (8, 8)])
def test_phase_path_matches_dilated_path(phase, h, w, dtype):
    tdt, _, rel = DTYPES[dtype]
    x, k, b = inputs(h, w, seed=1)
    xt, kt, bt = port_x(x, tdt), torch.from_numpy(k).to(tdt), torch.from_numpy(b).to(tdt)
    want = F.conv_transpose2d(xt, kt, bt, stride=2, padding=1)
    close(conv.conv_transpose2d(xt, kt, bt).float(), want.float(), rel, f"{dtype} {h}x{w}")


def test_phase_path_gradients_match_dilated_path(phase):
    """d(sum(y * g))/dx and /dw of the phase path against the dilated path's."""
    x, k, b = inputs(5, 6, seed=2)
    g = torch.from_numpy(np.random.default_rng(3).normal(size=(2, 8, 10, 12)).astype(np.float32))
    grads = []
    for fn in (conv.conv_transpose2d,
               lambda x, k, b: F.conv_transpose2d(x, k, b, stride=2, padding=1)):
        xt = port_x(x).requires_grad_()
        kt = torch.from_numpy(k).requires_grad_()
        bt = torch.from_numpy(b).requires_grad_()
        (fn(xt, kt, bt) * g).sum().backward()
        grads.append((xt.grad, kt.grad, bt.grad))
    for got, want, what in zip(*grads, ("x", "w", "b")):
        close(got, want, 1e-5, f"grad {what}")


@dataclass(frozen=True)
class InProcessStripes(Replica):
    """Stripe ``model_rank`` of ``whole`` (N, C, H, W) split in two along H, its
    halo exchange done in this process from ``whole`` (zeros beyond the image,
    as ``Replica.halo``)."""

    whole: Any = None

    def halo(self, x, top, bottom):
        h, m = x.shape[2], self.model_rank
        padded = F.pad(self.whole, (0, 0, top, bottom))
        rows = padded[:, :, m * h:m * h + top + h + bottom]
        return torch.cat([rows[:, :, :top], x, rows[:, :, top + h:]], 2)


@pytest.mark.parametrize("flag", [True, False], ids=["phase", "dilated"])
def test_upsample_layer_on_two_stripes_matches_one(monkeypatch, flag):
    """Each stripe's output of the 4x4 stride-2 transposed layer equals its rows
    of the one-process output, with the phase path on and off."""
    monkeypatch.setattr(conv, "PHASE_DECOMPOSE_CONV_TRANSPOSE", flag)
    layer = Conv2D(6, 8, 4, 2, 1, transpose=True, use_bias=True,
                   generator=torch.Generator().manual_seed(0))
    x, _, _ = inputs(8, 6, seed=4)
    whole = port_x(x)
    with torch.no_grad():
        want = layer(whole)
        for m in (0, 1):
            rep = InProcessStripes(model_rank=m, num_model=2, spatial=True, whole=whole)
            got = layer(whole[:, :, 4 * m:4 * (m + 1)], replica=rep)
            close(got, want[:, :, 8 * m:8 * (m + 1)], 1e-6 if flag else 0.0, f"stripe {m}")


def test_phase_path_takes_a_halo_only_with_the_flag():
    x, k, b = inputs(4, 4)
    with pytest.raises(ValueError, match="phase path"):
        conv.conv_transpose2d(port_x(x), torch.from_numpy(k), torch.from_numpy(b), halo=True)


def test_generator_forward_matches_jax_with_the_flag_on(phase):
    """A small notebook generator (depth 2: two upsample blocks, each with a
    transposed conv1 and shortcut) in eval mode, both packages on the phase path."""
    size = 16
    jcfg = jpreset("notebook")
    jcfg = jcfg.replace(generator=jcfg.generator.replace(depth=2, length=1, feature_size=4),
                        data=jcfg.data.replace(image_size=size),
                        train=jcfg.train.replace(use_pallas="off"))
    cfg = vt.Config.from_dict(jcfg.to_dict())
    jgen, _ = jbuild_models(jcfg)
    key = jax.random.key(0)
    v = jgen.init({"params": key, "dropout": key, "noise": key},
                  jnp.zeros((1, size, size, 1)), train=False)
    port = vt.build_generator(cfg, device="cpu")
    port.load_state_dict(vt.from_jax_variables(v), strict=True)
    x = np.random.default_rng(5).normal(size=(2, size, size, 1)).astype(np.float32)
    want = jgen.apply(v, x, train=False)
    with torch.no_grad():
        got = port(torch.from_numpy(x), train=False)
    for g, w, what in zip(got, want, ("recon", "mu", "log_var")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4, err_msg=what)
