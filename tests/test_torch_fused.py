"""The port's fused kernels on the CPU: their plain versions against the JAX
package's jnp fallbacks and identities, the Philox streams, the autograd
wiring, and the wrappers' checks. The CUDA kernels themselves are held against
these plain versions on the card by ``chip_smoke.py``."""

import jax
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


# ---------------------------------------------------------------------------
# row 2: bn_act_dropout backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stats", ["running", "batch"])
@pytest.mark.parametrize("c", [1, 3, 64])
def test_backward_plain_matches_jax_vjp_p0(c, stats):
    """The backward's plain version against ``jax.vjp`` of the JAX package's
    ``bn_act_dropout`` (its jnp fallback on the CPU), p = 0: with running stats
    all five gradients directly; with batch stats the whole chain through
    ``batch_stats`` (autograd carries dmean and dvar into x). Tolerance 2e-5 of
    each gradient's scale: sums over 70 rows in two orders."""
    x, mean, var, scale, bias = inputs(c)
    g = np.random.default_rng(5).normal(size=x.shape).astype(np.float32)
    seed0 = jnp.zeros((), jnp.int32)
    if stats == "running":
        f = lambda *a: pf.bn_act_dropout(*a, seed0, SLOPE, 0.0)  # noqa: E731
        _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (x, mean, var, scale, bias)))
        jdx, jdm, jdv, jds, jdb = vjp(jnp.asarray(g))
        dx, ds, db, dm, dv = fused.bn_act_dropout_backward(
            nchw(x), nchw(g), t(mean), t(var), t(scale), t(bias), 0, SLOPE, 0.0)
        pairs = [(nhwc(dx), jdx), (dm, jdm), (dv, jdv), (ds, jds), (db, jdb)]
    else:
        def f(x, scale, bias):
            m, v, _, _ = jax_batch_stats(x, jnp.asarray(mean), jnp.asarray(var),
                                         use_running_average=False)
            return pf.bn_act_dropout(x, m, v, scale, bias, seed0, SLOPE, 0.0)
        _, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
        jdx, jds, jdb = vjp(jnp.asarray(g))
        xt = nchw(x).requires_grad_(True)
        st, bt = t(scale).requires_grad_(True), t(bias).requires_grad_(True)
        m, v, _, _ = batch_stats(xt, t(mean), t(var), use_running_average=False)
        y = fused.bn_act_dropout(xt, m, v, st, bt, 0, SLOPE, 0.0)
        dx, ds, db = torch.autograd.grad(y, (xt, st, bt), nchw(g))
        pairs = [(nhwc(dx), jdx), (ds, jds), (db, jdb)]
    for got, want in pairs:
        got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-5 * max(1.0, float(np.abs(want).max())))


def test_backward_replays_the_forward_mask():
    """At p = 0.5 the backward's dx is zero exactly where the forward dropped."""
    x, mean, var, scale, bias = inputs(16, shape=(4, 8, 8))
    args = (t(mean), t(var), t(scale), t(bias), 99, SLOPE, 0.5)
    y = fused.bn_act_dropout(nchw(x), *args)
    dx = fused.bn_act_dropout_backward(nchw(x), torch.ones_like(y), *args)[0]
    assert torch.equal(dx == 0, y == 0)
    assert torch.equal(y != 0, fused.keep_mask(nchw(x), 99, 0.5))


@pytest.mark.parametrize("mode", ["level", "upsample"])
def test_fused_block_p05_matches_jax_unfused_block(mode):
    """One train-mode ``ResBlockVAE`` at p = 0.5: the port's fused block (both
    kernels' plain versions, the mask from its own seed) against the JAX
    package's unfused block with that mask injected; output, gradients of the
    input and of every parameter, and the running statistics. Tolerance 1e-4 of
    each tensor's scale (oneDNN and XLA:CPU sum convolutions in different orders)."""
    from vaegan_tpu.models import ResBlockVAE as JBlock
    from vaegan_tpu_torch.interop import from_jax_variables
    from vaegan_tpu_torch.models import ResBlockVAE

    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    jblk = JBlock(8, mode=mode)
    v = jblk.init({"params": jax.random.key(0)}, jnp.asarray(x), train=False)
    port = ResBlockVAE(3, 8, mode, use_pallas=True)
    # the upsample rule reads the block's name: nest the block under one
    prefix = f"block-{mode}."
    sd = from_jax_variables({k: {prefix[:-1]: c} for k, c in v.items()})
    port.load_state_dict({k[len(prefix):]: c for k, c in sd.items()}, strict=True)
    xt = nchw(x).requires_grad_(True)
    y = port(xt, train=True, seeds=torch.Generator().manual_seed(4))
    seed, shape = port.bn1.last_draw
    mask = fused.keep_mask(torch.empty(shape).contiguous(memory_format=torch.channels_last),
                           seed, 0.5)
    w = rng.normal(size=nhwc(y.detach()).shape).astype(np.float32)
    params = dict(port.named_parameters())
    grads = torch.autograd.grad((y * nchw(w)).sum(), [xt] + list(params.values()))

    masks = {"dropout": {"mask": jnp.asarray(nhwc(mask.float()) > 0)}}

    def loss(params, x):
        out, upd = jblk.apply({"params": params, "batch_stats": v["batch_stats"],
                               "masks": masks}, x, train=True, mutable=["batch_stats"])
        return jnp.sum(out * w), (out, upd)

    (_, (jy, upd)), (jg, jgx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        v["params"], jnp.asarray(x))
    tol = lambda a: dict(rtol=0, atol=1e-4 * max(1.0, float(np.abs(a).max())))  # noqa: E731
    np.testing.assert_allclose(nhwc(y.detach()), np.asarray(jy), **tol(jy))
    np.testing.assert_allclose(nhwc(grads[0]), np.asarray(jgx), **tol(jgx))
    want = {k[len(prefix):]: c for k, c in
            from_jax_variables({"params": {prefix[:-1]: jg}}).items()}
    for (name, _), g in zip(params.items(), grads[1:]):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), err_msg=name,
                                   **tol(want[name].numpy()))
    stats = {k[len(prefix):]: c for k, c in
             from_jax_variables({"batch_stats": {prefix[:-1]: upd["batch_stats"]}}).items()}
    sd = port.state_dict()
    for k, val in stats.items():
        np.testing.assert_allclose(sd[k].numpy(), val.numpy(), rtol=1e-5, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# rows 3 and 4: reparam_kl forward and backward
# ---------------------------------------------------------------------------

def _mu_lv(shape=(2, 6, 5, 7), seed=8):
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=shape).astype(np.float32)
    lv = (rng.normal(size=shape) * 0.5).astype(np.float32)
    return mu, lv


def test_reparam_identities():
    """The identities ``tests/tpu_check.py`` holds the TPU kernel to, on the plain
    version: z - mu = e^{lv/2} eps with the replayed eps; the KL equals
    ``losses.kl_divergence``; d sum z / d mu = 1 and d sum z / d lv = (z - mu) / 2;
    d kl / d mu = mu and d kl / d lv = -(1 - e^lv) / 2. Tolerance 1e-5 relative."""
    from vaegan_tpu import losses as jlosses

    mu, lv = _mu_lv()
    mut, lvt = nchw(mu).requires_grad_(True), nchw(lv).requires_grad_(True)
    z, kl = fused.reparam_kl(mut, lvt, 31)
    eps = fused.reparam_noise(mut.shape, 31, "cpu")
    np.testing.assert_allclose((z - mut).detach().numpy(),
                               (torch.exp(0.5 * lvt) * eps).detach().numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(kl.detach()), float(jlosses.kl_divergence(mu, lv, "sum")),
                               rtol=1e-5)
    dmu, dlv = torch.autograd.grad(z.sum(), (mut, lvt), retain_graph=True)
    assert torch.equal(dmu, torch.ones_like(dmu))
    np.testing.assert_allclose(dlv.numpy(), ((z - mut) / 2).detach().numpy(), rtol=1e-5, atol=1e-6)
    kmu, klv = torch.autograd.grad(kl, (mut, lvt))
    np.testing.assert_allclose(kmu.numpy(), mut.detach().numpy(), rtol=1e-6)
    np.testing.assert_allclose(klv.numpy(), (-0.5 * (1 - torch.exp(lvt))).detach().numpy(),
                               rtol=1e-5, atol=1e-6)


def test_reparam_noise_moments_and_streams():
    """eps over 2**20 draws: mean 0, variance 1, kurtosis 3 (within 5 standard
    errors); a pure function of (seed, index), independent of the dropout
    stream's words for the same seed."""
    eps = fused.reparam_noise((1, 1, 1024, 1024), 12, "cpu").reshape(-1).double()
    n = eps.numel()
    assert abs(float(eps.mean())) < 5 / n ** 0.5
    assert abs(float(eps.var()) - 1.0) < 5 * (2 / n) ** 0.5
    assert abs(float((eps ** 4).mean()) - 3.0) < 5 * (96 / n) ** 0.5
    a = fused.reparam_noise((2, 3, 4, 5), 12, "cpu").permute(0, 2, 3, 1).reshape(-1)
    assert torch.equal(a, eps[:120].float())
    bits = fused.dropout_bits(8, 12, "cpu")
    w = fused.philox4x32_10(*(torch.tensor([v]) for v in (0, 0, 1, 0)), 12, 0)
    assert int(w[0]) not in bits.tolist()


def test_reparam_kl_cotangent_none_counts_as_zero():
    mu, lv = _mu_lv()
    g = nchw(np.random.default_rng(1).normal(size=mu.shape).astype(np.float32))
    a = fused.reparam_kl_backward(nchw(mu), nchw(lv), g, None, 5)
    b = fused.reparam_kl_backward(nchw(mu), nchw(lv), g, torch.zeros(()), 5)
    assert all(torch.equal(p, q) for p, q in zip(a, b))


# ---------------------------------------------------------------------------
# row 5: recon_loss_sums
# ---------------------------------------------------------------------------

# n = 189 (not a multiple of 4, below one block's pass), 1000 (below 1024) and
# 49,149 (ragged, three clusters of the kernel's grid at a width of one channel)
RECON_SHAPES = [(3, 9, 7, 1), (2, 20, 25, 1), (3, 127, 129, 1)]


@pytest.mark.parametrize("shape", RECON_SHAPES, ids=lambda s: f"n{int(np.prod(s))}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_recon_loss_sums_matches_jax_and_its_grad(dtype, shape):
    """Sums against ``pallas_fused.recon_loss_sums`` (its jnp fallback) on the same
    values, and the plain-PyTorch backward against its ``jax.vjp``. Both sides
    upcast to f32, so the sums differ only in the order of addition: 1e-6 relative
    in either dtype. The gradients: f32 1e-6; bf16 one bf16 ulp (both round the
    same f32 gradient to bf16)."""
    rng = np.random.default_rng(2)
    r = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
    tt = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jr, jt = (jnp.asarray(a.float().numpy()).astype(jdtype) for a in (r, tt))
    ct = np.asarray([0.7, -1.3], np.float32)
    want, vjp = jax.vjp(pf.recon_loss_sums, jr, jt)
    jdr, jdt = (np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(ct)))
    rt, tt_ = r.clone().requires_grad_(True), tt.clone().requires_grad_(True)
    got = fused.recon_loss_sums(rt, tt_)
    assert got.dtype == torch.float32 and got.shape == (2,)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6)
    dr, dt = torch.autograd.grad(got, (rt, tt_), t(ct))
    assert dr.dtype == dtype and dt.dtype == dtype
    for g, want_g in ((dr, jdr), (dt, jdt)):
        g = g.float().numpy()
        if dtype == torch.float32:
            np.testing.assert_allclose(g, want_g, rtol=1e-6, atol=1e-6)
        else:
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want_g), 1e-30))) - 7)
            assert np.all(np.abs(g - want_g) <= ulp)
    if int(np.prod(shape)) > 2 ** 15:
        assert fused._recon_launch_shape(int(np.prod(shape)), 132).clusters == 3


@pytest.mark.parametrize("bad", ["reparam_shape", "reparam_dtype", "recon_dtype", "bwd_channels",
                                 "bwd_grad_shape", "reparam_grad_shape", "reparam_gkl_shape",
                                 "reparam_seed"])
def test_new_wrappers_reject(bad):
    mu, lv = _mu_lv()
    with pytest.raises((ValueError, TypeError)):
        if bad == "reparam_shape":
            fused.reparam_kl_forward(nchw(mu), nchw(lv)[:1], 0)
        elif bad == "reparam_dtype":
            fused.reparam_kl_forward(nchw(mu), nchw(lv).double(), 0)
        elif bad == "recon_dtype":
            fused.recon_loss_sums_forward(t(mu), t(lv).double())
        elif bad == "bwd_grad_shape":
            # the kernel reads x.numel() elements of g
            x, mean, var, scale, bias = inputs(4)
            fused.bn_act_dropout_backward(nchw(x), nchw(x)[:1], t(mean), t(var), t(scale),
                                          t(bias), 0, SLOPE, 0.0)
        elif bad == "reparam_grad_shape":
            fused.reparam_kl_backward(nchw(mu), nchw(lv), nchw(mu)[:1], None, 0)
        elif bad == "reparam_gkl_shape":
            fused.reparam_kl_backward(nchw(mu), nchw(lv), nchw(mu), torch.ones(2), 0)
        elif bad == "reparam_seed":
            fused.reparam_kl_forward(nchw(mu), nchw(lv), -1)
        else:
            x = torch.zeros(1, fused.MAX_CHANNELS + 1, 1, 1).contiguous(
                memory_format=torch.channels_last)
            v = torch.zeros(fused.MAX_CHANNELS + 1)
            fused.bn_act_dropout_backward(x, x, v, v, v, v, 0, SLOPE, 0.0)


def test_cpu_tensors_launch_no_kernel():
    before = dict(fused.LAUNCHES)
    mu, lv = _mu_lv()
    z, kl = fused.reparam_kl(nchw(mu).requires_grad_(True), nchw(lv), 3)
    z.sum().backward()
    fused.recon_loss_sums(t(mu), t(lv))
    assert fused.LAUNCHES == before


# ---------------------------------------------------------------------------
# launch shapes of the one-launch grid reductions (csrc/grid_reduce.cuh)
# ---------------------------------------------------------------------------

def _check_grid(shape, n, per_block, max_clusters):
    """Whole clusters, at least one, at most ``max_clusters``, and no cluster more
    than the elements need."""
    assert shape.blocks % fused.CLUSTER == 0 and shape.blocks >= fused.CLUSTER
    assert shape.clusters == shape.blocks // fused.CLUSTER <= max_clusters
    assert shape.clusters == 1 or (shape.clusters - 1) * fused.CLUSTER * per_block < n


@pytest.mark.parametrize("max_clusters", [1, 66])
@pytest.mark.parametrize("n_per_c", [1, 300, 4 * 256 * 256])
@pytest.mark.parametrize("c", [1, 64, 128, 256, 96, 3])
def test_bwd_launch_shape(c, n_per_c, max_clusters):
    """C of the step's sites (1, 64, 128, 256) and two that do not divide 1024,
    n from below one block to a full site: a block's slots span a multiple of C,
    and so does the grid's stride, so each thread slot meets the same channels on
    every pass; the scratch holds one row of 2C sums per cluster."""
    n = c * n_per_c
    shape = fused._bwd_launch_shape(c, n, max_clusters)
    assert (shape.threads * shape.vec) % c == 0
    assert shape.vec in (1, 4) and shape.threads <= (256 if shape.vec == 4 else 1024)
    assert (shape.blocks * shape.threads * shape.vec) % c == 0
    _check_grid(shape, n, shape.threads * shape.vec, max_clusters)
    rows = fused._reduction_scratch(shape, 2 * c, "cpu")
    assert rows.shape == (shape.blocks // fused.CLUSTER, 2 * c) and rows.dtype == torch.float32


@pytest.mark.parametrize("max_clusters", [1, 99])
@pytest.mark.parametrize("n", [1, 1023, 1024 * fused.CLUSTER + 1, 4 * 256 * 64 * 64])
def test_reparam_launch_shape(n, max_clusters):
    shape = fused._reparam_launch_shape(n, max_clusters)
    assert (shape.threads, shape.vec) == (256, 4)
    _check_grid(shape, n, 1024, max_clusters)
    assert fused._reduction_scratch(shape, 1, "cpu").shape == (shape.clusters, 1)


@pytest.mark.parametrize("max_clusters", [1, 132])
@pytest.mark.parametrize("n", [1, 2047, 2048 * fused.CLUSTER + 1, 4 * 256 * 256, 16 * 256 * 256])
def test_recon_launch_shape(n, max_clusters):
    """recon_loss_sums: 256 threads of 8 elements a pass, one row of two sums per
    cluster."""
    shape = fused._recon_launch_shape(n, max_clusters)
    assert (shape.threads, shape.vec) == (256, 8)
    _check_grid(shape, n, 256 * 8, max_clusters)
    assert fused._reduction_scratch(shape, 2, "cpu").shape == (shape.clusters, 2)


@pytest.mark.parametrize("answer", [62, 0, -2])
def test_max_clusters_is_the_occupancy_query_or_raises(monkeypatch, answer):
    """The grid's cap is what ``cudaOccupancyMaxActiveClusters`` answers; no cluster
    fitting, or a CUDA error (a negative code), raises."""
    calls = []

    def kernel_fn(lib, name, argtypes):
        return lambda *args: calls.append(args) or answer

    monkeypatch.setattr(fused, "_kernel_fn", kernel_fn)
    args = ("test_lib", f"test_query_{answer}", "test_device", 64, 0, 1)
    if answer > 0:
        assert fused._max_clusters(*args) == answer
        assert fused._max_clusters(*args) == answer and calls == [(64, 0, 1)]  # asked once
    else:
        with pytest.raises(RuntimeError):
            fused._max_clusters(*args)


def test_ticket_counter_per_stream(monkeypatch):
    """One zeroed int32 counter per (device, stream): launches on one stream share
    it, since they never overlap; two streams, which may, never do."""
    monkeypatch.setattr(fused, "_TICKETS", {})
    a = fused._ticket("cpu", 7)
    assert a.dtype == torch.int32 and a.shape == (1,) and int(a) == 0
    assert fused._ticket(torch.device("cpu"), 7) is a
    assert fused._ticket("cpu", 8) is not a
