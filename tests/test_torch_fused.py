"""The port's fused BN + LeakyReLU + dropout, on the CPU: its plain version
against the JAX package's jnp fallback, the Philox dropout stream, and the
wrapper's checks. The CUDA kernel itself is held against this plain version on
the card by ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vaegan_tpu.ops import pallas_fused as pf
from vaegan_tpu.ops.norm import batch_stats as jax_batch_stats
from vaegan_tpu_torch.ops import fused
from vaegan_tpu_torch.ops.norm import batch_stats

SLOPE = 0.01


def nchw(a: np.ndarray) -> torch.Tensor:
    """NHWC numpy -> the port's (N, C, H, W) channels_last tensor (no copy)."""
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).float().numpy()


def inputs(c, shape=(2, 5, 7), seed=0):
    """x (N, H, W, C) with M = N*H*W = 70, a multiple of no block size, and
    per-channel running stats / affine params."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape + (c,)).astype(np.float32) * 1.5 + 0.3
    mean = rng.normal(size=c).astype(np.float32) * 0.3
    var = rng.uniform(0.5, 2.0, size=c).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, size=c).astype(np.float32)
    bias = rng.normal(size=c).astype(np.float32) * 0.1
    return x, mean, var, scale, bias


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


@pytest.mark.parametrize("stats", ["running", "batch"])
@pytest.mark.parametrize("c", [1, 3, 64])
def test_plain_matches_jax_fallback_p0(c, stats):
    x, mean, var, scale, bias = inputs(c)
    if stats == "batch":
        jm, jv, _, _ = jax_batch_stats(jnp.asarray(x), jnp.asarray(mean), jnp.asarray(var),
                                       use_running_average=False)
        tm, tv, _, _ = batch_stats(nchw(x), t(mean), t(var), use_running_average=False)
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
        jmean, jvar, tmean, tvar = jm, jv, tm, tv
    else:
        jmean, jvar, tmean, tvar = jnp.asarray(mean), jnp.asarray(var), t(mean), t(var)
    want = pf.bn_act_dropout(jnp.asarray(x), jmean, jvar, jnp.asarray(scale),
                             jnp.asarray(bias), jnp.zeros((), jnp.int32), SLOPE, 0.0)
    got = fused.bn_act_dropout(nchw(x), tmean, tvar, t(scale), t(bias), 0, SLOPE, 0.0)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_plain_bf16_matches_jax_fallback():
    x, mean, var, scale, bias = inputs(8)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    want = pf.bn_act_dropout(jnp.asarray(xb.float().numpy(), jnp.bfloat16), jnp.asarray(mean),
                             jnp.asarray(var), jnp.asarray(scale), jnp.asarray(bias),
                             jnp.zeros((), jnp.int32), SLOPE, 0.0)
    got = fused.bn_act_dropout(xb.permute(0, 3, 1, 2), t(mean), t(var), t(scale), t(bias),
                               0, SLOPE, 0.0)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    # both compute in f32 and round once to bf16: at most one bf16 ulp apart
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(np.abs(nhwc(got) - want) <= ulp)


class TestDropout:
    def _y(self, p, seed=7, shape=(8, 16, 16)):
        x, mean, var, scale, bias = inputs(32, shape=shape)
        return fused.bn_act_dropout(nchw(x), t(mean), t(var), t(scale), t(bias),
                                    seed, SLOPE, p)

    def test_keep_rate_and_scaling(self):
        y0, y = nhwc(self._y(0.0)), nhwc(self._y(0.5))
        kept = y != 0
        assert 0.45 <= kept.mean() <= 0.55
        np.testing.assert_allclose(y[kept], y0[kept] / (1.0 - 0.5), rtol=1e-6)

    def test_mask_is_a_function_of_seed_and_index(self):
        a, b, other = self._y(0.5), self._y(0.5), self._y(0.5, seed=8)
        assert torch.equal(a, b)
        assert not torch.equal(a != 0, other != 0)

    def test_mask_does_not_depend_on_batch_shape(self):
        x = nchw(np.zeros((4, 6, 5, 3), np.float32))
        whole = fused.keep_mask(x, 11, 0.5).permute(0, 2, 3, 1).reshape(-1)
        regrouped = nchw(np.zeros((2, 12, 5, 3), np.float32))
        again = fused.keep_mask(regrouped, 11, 0.5).permute(0, 2, 3, 1).reshape(-1)
        assert torch.equal(whole, again)
        # a prefix of the index space draws the same bits whatever the total size
        assert torch.equal(fused.dropout_bits(37, 11, "cpu"),
                           fused.dropout_bits(1000, 11, "cpu")[:37])

    def test_cpu_path_does_not_count_launches(self):
        before = dict(fused.LAUNCHES)
        self._y(0.5)
        self._y(0.0)
        assert fused.LAUNCHES == before


# Random123's known-answer vectors for philox4x32 with 10 rounds:
# (counter words, key words) -> output words
PHILOX_KAT = [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
]


@pytest.mark.parametrize("ctr,key,want", PHILOX_KAT)
def test_philox_known_answers(ctr, key, want):
    words = fused.philox4x32_10(*(torch.tensor([c], dtype=torch.int64) for c in ctr), *key)
    assert tuple(int(w) for w in words) == want


@pytest.mark.parametrize("bad", ["nchw_layout", "float64", "vector_shape", "p_one"])
def test_wrapper_rejects(bad):
    x, mean, var, scale, bias = inputs(4)
    xt, p = nchw(x), 0.0
    vecs = [t(mean), t(var), t(scale), t(bias)]
    if bad == "nchw_layout":
        xt = xt.contiguous()
    elif bad == "float64":
        xt = xt.double()
    elif bad == "vector_shape":
        vecs[2] = t(np.ones(5))
    else:
        p = 1.0
    with pytest.raises((ValueError, TypeError)):
        fused.bn_act_dropout(xt, *vecs, 0, SLOPE, p)
