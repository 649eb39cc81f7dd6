"""The port's step cost count (``vaegan_tpu_torch.utils.cost_analysis``) on the
CPU: flops of a ``Conv2D`` and a ``Linear`` through forward, backward and the
gradient penalty's grad-of-grad against the count from their shapes, bytes of
an elementwise op and of a view, the fused kernels counted by their formula,
a tiny notebook step, and that step's flops beside XLA's cost analysis of the
JAX step on the same config."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vaegan_tpu.train.state as jstate_mod
import vaegan_tpu.train.step as jstep_mod
from vaegan_tpu.config import preset as jpreset
import vaegan_tpu_torch as vt
from vaegan_tpu_torch.models.layers import Conv2D, Linear
from vaegan_tpu_torch.ops import fused
from vaegan_tpu_torch.utils.cost_analysis import step_cost

torch.set_num_threads(1)

N, C, H, K, CO = 2, 3, 8, 3, 5          # the convolution's batch, channels, size, kernel
B, IN, OUT = 3, 7, 4                    # the linear's batch and widths


def _layer(kind):
    """(layer, input, the forward's flops from the shapes: 2 a multiply-add)."""
    g = torch.Generator().manual_seed(0)
    if kind == "conv":
        x = torch.randn(N, C, H, H, generator=g).contiguous(memory_format=torch.channels_last)
        return Conv2D(C, CO, K, 1, 1, use_bias=True, generator=g), x, 2 * N * CO * H * H * C * K * K
    return Linear(IN, OUT), torch.randn(B, IN, generator=g), 2 * B * IN * OUT


# multiples of the forward's flops. backward: the weight's gradient (the input
# needs none). penalty: the forward, the input gradient, and in the backward of
# its square the weight's gradient of that input gradient; neither computes
# the gradient of the output gradient, the sum's constant ones (a Conv2D's
# route, ops.conv.InputGrad, takes it only where the output gradient requires
# one)
PHASES = {"forward": {"conv": 1, "linear": 1}, "backward": {"conv": 2, "linear": 2},
          "penalty": {"conv": 3, "linear": 3}}


@pytest.mark.parametrize("kind", ["conv", "linear"])
@pytest.mark.parametrize("phase", list(PHASES))
def test_layer_flops_equal_the_count_from_the_shapes(kind, phase):
    layer, x, fwd = _layer(kind)

    def run():
        if phase == "forward":
            with torch.no_grad():
                layer(x)
        elif phase == "backward":
            layer(x).sum().backward()
        else:
            xr = x.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(layer(xr).sum(), xr, create_graph=True)
            (g * g).sum().backward()

    assert step_cost(run)["flops"] == PHASES[phase][kind] * fwd


def test_elementwise_bytes_are_inputs_and_outputs_and_a_view_is_free():
    a, b = torch.randn(100), torch.randn(100)
    assert step_cost(lambda: a + b)["bytes accessed"] == 3 * 400
    assert step_cost(lambda: a.view(10, 10).t())["bytes accessed"] == 0
    assert step_cost(lambda: a.add_(b))["bytes accessed"] == 3 * 400    # read a, b; write a
    assert step_cost(lambda: a.copy_(b))["bytes accessed"] == 2 * 400   # read b; write a
    assert step_cost(lambda: torch.add(a, a))["bytes accessed"] == 2 * 400   # a read once
    assert step_cost(lambda: torch.empty(1000))["bytes accessed"] == 0


def test_a_triad_repetition_counts_what_the_bench_divides_by():
    """``bench.triad_rep`` (an ``out=`` op) reads two arrays and writes one: the
    3 x 4 bytes an element the roofline's achieved rate is computed from."""
    from vaegan_tpu_torch import bench

    y, b = torch.ones(1000), torch.full((1000,), 2.0)
    assert step_cost(bench.triad_rep, y, b)["bytes accessed"] == 3 * 4 * 1000


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_plain_paths_are_counted_by_formula(dtype):
    """On the CPU the kernels run their plain versions; the count takes the
    kernels' formula (``fused.kernel_cost``) and none of the plain ops."""
    g = torch.Generator().manual_seed(1)
    r, t = (torch.rand(2, 8, 8, 1, generator=g).to(dtype) for _ in range(2))
    cost = step_cost(lambda: fused.recon_loss_sums(r, t))
    want = fused.kernel_cost("recon_loss_sums", r.numel(), elem_bytes=r.element_size())
    assert (cost["bytes accessed"], cost["flops"]) == want
    assert cost["kernels"] == {"recon_loss_sums": {"calls": 1, "bytes": want[0],
                                                   "flops": want[1]}}
    x = torch.randn(2, 6, 4, 4, generator=g).to(dtype).contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    vecs = [torch.rand(6, generator=g) + 0.5 for _ in range(4)]
    cost = step_cost(lambda: fused.bn_act_dropout(x, *vecs, 7, 0.01, 0.5).float().sum()
                     .backward())
    fwd = fused.kernel_cost("bn_act_dropout", x.numel(), 6, x.element_size(), True)
    bwd = fused.kernel_cost("bn_act_dropout_bwd", x.numel(), 6, x.element_size(), True)
    assert cost["kernels"] == {"bn_act_dropout": {"calls": 1, "bytes": fwd[0], "flops": fwd[1]},
                               "bn_act_dropout_bwd": {"calls": 1, "bytes": bwd[0],
                                                      "flops": bwd[1]}}
    assert fused.kernel_cost("bn_act_dropout", 1000, 8, 4, False) == (8000 + 128, 6000)
    assert fused.ops_per_element("bn_act_dropout", 2, True) == 6 + 30 + 2


def test_the_kernel_hook_is_set_only_while_a_count_runs():
    """``fused.counting`` sets the one hook the wrappers test, refuses a second
    count inside the first, and clears the hook after, also when the counted
    call raises."""
    assert fused._COST is None
    with pytest.raises(RuntimeError, match="already running"):
        step_cost(step_cost, lambda: None)
    assert fused._COST is None
    with pytest.raises(ValueError):
        step_cost(lambda: fused.recon_loss_sums(torch.ones(2), torch.ones(3)))
    assert fused._COST is None


def _tiny(name="notebook", mode="off"):
    jcfg = jpreset(name)
    jcfg = jcfg.replace(
        generator=jcfg.generator.replace(depth=1, length=1, feature_size=4, dropout_prob=0.0),
        discriminator=jcfg.discriminator.replace(
            num_features_conv1=8, num_blocks=(1, 1), num_strides_res=(1, 2),
            num_features_res=(8, 16), linear_widths=(16, 8), dropout_prob=0.0),
        data=jcfg.data.replace(image_size=16, batch_size=2),
        train=jcfg.train.replace(use_pallas=mode))
    return jcfg, vt.Config.from_dict(jcfg.to_dict())


@pytest.mark.parametrize("mode", ["off", "all"])
def test_a_tiny_step_counts_the_same_twice(mode):
    _, cfg = _tiny(mode=mode)
    state = vt.create_train_state(cfg, device="cpu")
    step = vt.make_train_step(cfg, True)
    batch = torch.rand(2, 16, 16, 1, generator=torch.Generator().manual_seed(2))
    state, _ = step(state, batch, 0)        # the optimizers' state exists from here on
    a = step_cost(step, state, batch, 1)
    b = step_cost(step, state, batch, 2)
    assert a["flops"] > 0 and a["bytes accessed"] > 0
    assert (a["flops"], a["bytes accessed"], a["kernels"]) == (
        b["flops"], b["bytes accessed"], b["kernels"])
    assert set(a["kernels"]) == (set() if mode == "off" else set(fused.LAUNCHES))


def test_step_flops_beside_xla_cost_analysis():
    """The port's count of the tiny notebook step against XLA's cost analysis of
    the JAX step on the same config. XLA counts after fusion and counts every
    float op, elementwise ones too; the port counts convolutions and matmuls
    (and the kernels' operations). Measured on the CPU at 16x16 and 32x32,
    batch 2, generator feature size 4, and at 32x32, batch 4, feature size 8,
    the count read 0.980, 0.945 and 0.957 of XLA's flops, so it is held to
    [0.9, 1.0] of them; bytes are not held (eager PyTorch does not fuse: 2.7-2.9x
    XLA's there)."""
    jcfg, cfg = _tiny()
    jstate = jstate_mod.create_train_state(jcfg, jax.random.key(0))
    x = np.random.default_rng(0).random((2, 16, 16, 1), np.float32)
    ca = jax.jit(jstep_mod.make_train_step(jcfg, True)).lower(
        jstate, jnp.asarray(x), jax.random.key(1)).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, (list, tuple)) else ca
    state = vt.create_train_state(cfg, device="cpu")
    step = vt.make_train_step(cfg, True)
    state, _ = step(state, torch.from_numpy(x), 0)
    cost = step_cost(step, state, torch.from_numpy(x), 1)
    ratio = cost["flops"] / ca["flops"]
    msg = (f"port flops {cost['flops']:.0f}, XLA flops {ca['flops']:.0f} (ratio {ratio:.3f}); "
           f"port bytes {cost['bytes accessed']:.0f}, XLA bytes {ca['bytes accessed']:.0f}")
    assert 0.9 <= ratio <= 1.0, msg
