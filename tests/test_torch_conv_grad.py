"""The convolution whose input gradient the gradient penalty differentiates
again (``vaegan_tpu_torch.ops.conv.conv2d``, ``Conv2D``'s route where autograd
records the call), against ``F.conv2d`` and its default autograd.

- ``gradcheck`` and ``gradgradcheck`` in float64 over the critic's forms: 3x3
  at stride 1 and 2 on odd and even sizes, 1x1, one input channel, with and
  without a bias, channels_last and contiguous, and a stripe's padding
  ``(0, p)``; the output and first-order gradients are ``F.conv2d``'s.
- A small critic with spectral norm and the plain BN path, wholly in float64
  (the port's float32 statistics are kept in float64 for the test, so the two
  routes' sums meet at float64's precision): the penalty's parameter gradients
  of both routes within 1e-12 of the largest.
- One float32 two-optimizer step against today's, within
  ``tests/test_torch_train_step.py``'s tolerances.
- Op counts under ``torch.profiler``, per phase of the step (its ``step.*``
  spans): the penalty's inner gradient and the G half issue no more
  ``aten::convolution_backward`` through the critic than the default route and
  compute the same dgrads and wgrads; the critic's backward (``d_backward``)
  issues no convolution whose filter has the activation's spatial size, one
  wgrad in place of each such convolution, and one dgrad more: the
  interpolates' first convolution's, whose input requires a gradient that no
  pass asks for.
- ``conv.penalty_wgrad`` counts the full-architecture critic's 10 convolutions
  on a penalty step, none without the penalty and none in serving.
"""

from __future__ import annotations

import copy
from collections import Counter, defaultdict

import pytest
import torch
import torch.nn.functional as F
from torch.autograd import gradcheck, gradgradcheck
from torch.profiler import ProfilerActivity, profile

import vaegan_tpu_torch as vt
from vaegan_tpu_torch import inference, losses
from vaegan_tpu_torch.models import Discriminator, layers
from vaegan_tpu_torch.ops import conv
from vaegan_tpu_torch.utils import profiling

torch.set_num_threads(1)

SIZE, BATCH = 16, 4
ROUTE = conv.conv2d


def default_conv2d(x, w, b=None, stride=1, padding=0):
    return F.conv2d(x, w, b, stride=stride, padding=padding)


@pytest.fixture
def default_route(monkeypatch):
    """A context in which ``Conv2D`` convolves with ``F.conv2d`` and its
    default autograd."""
    class Route:
        def __enter__(self):
            monkeypatch.setattr(conv, "conv2d", default_conv2d)

        def __exit__(self, *exc):
            monkeypatch.setattr(conv, "conv2d", ROUTE)
    return Route()


# (in channels, kernel, stride, padding, H, bias, channels_last)
FORMS = {
    "3x3_s1_odd": (3, 3, 1, 1, 7, True, True),
    "3x3_s1_even": (3, 3, 1, 1, 8, False, True),
    "3x3_s2_odd": (3, 3, 2, 1, 7, True, True),
    "3x3_s2_even": (3, 3, 2, 1, 8, False, True),
    "3x3_s2_contiguous": (3, 3, 2, 1, 8, True, False),
    "1x1": (4, 1, 1, 0, 5, True, True),
    "1x1_contiguous": (4, 1, 1, 0, 6, False, False),
    "cin1": (1, 3, 1, 1, 6, False, True),
    "cin1_s2_bias": (1, 3, 2, 1, 7, True, True),
    "stripe_halo": (2, 3, 1, (0, 1), 6, True, True),
    "stripe_halo_s2": (2, 3, 2, (0, 1), 7, False, True),
}


def form(name, dtype=torch.float64, seed=0):
    cin, k, s, p, h, bias, cl = FORMS[name]
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, cin, h, h + 1, dtype=dtype, generator=g)
    if cl:
        x = x.contiguous(memory_format=torch.channels_last)
    w = torch.randn(3, cin, k, k, dtype=dtype, generator=g)
    b = torch.randn(3, dtype=dtype, generator=g) if bias else None
    args = [t.requires_grad_() for t in (x, w, b) if t is not None]
    return args, (lambda x, w, *b: conv.conv2d(x, w, *b, stride=s, padding=p)), (s, p)


@pytest.mark.parametrize("name", FORMS)
def test_gradcheck(name):
    args, fn, _ = form(name)
    assert gradcheck(fn, args)


@pytest.mark.parametrize("name", FORMS)
def test_gradgradcheck(name):
    args, fn, _ = form(name)
    assert gradgradcheck(fn, args)


@pytest.mark.parametrize("name", FORMS)
def test_output_and_first_order_gradients_are_conv2ds(name):
    args, fn, (s, p) = form(name, torch.float32)
    y = fn(*args)
    want = F.conv2d(*args, stride=s, padding=p)
    assert torch.equal(y, want)
    gy = torch.randn_like(y)
    got = torch.autograd.grad(y, args, gy)
    for a, b in zip(got, torch.autograd.grad(want, args, gy)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_without_an_input_gradient_it_is_the_plain_call(monkeypatch):
    """Grad disabled (serving's ``inference_mode``, evaluation's ``no_grad``)
    or an input that needs no gradient: one ``F.conv2d`` of ``x`` itself."""
    seen, conv2d = [], F.conv2d
    monkeypatch.setattr(F, "conv2d", lambda x, *a, **k: seen.append(x) or conv2d(x, *a, **k))
    x = torch.randn(1, 2, 5, 5)
    w = torch.randn(3, 2, 3, 3, requires_grad=True)
    for ctx in (torch.inference_mode, torch.no_grad):
        with ctx():
            y = conv.conv2d(x.requires_grad_(ctx is torch.no_grad), w, None, 1, 1)
        assert y.grad_fn is None
    x.requires_grad_(False)
    assert type(conv.conv2d(x, w, None, 1, 1).grad_fn).__name__ == "ConvolutionBackward0"
    assert len(seen) == 3 and all(s is x for s in seen)


def float64_critic(monkeypatch, remat=False):
    """A small critic (spectral norm on the blocks, the plain BN path) held in
    float64 throughout: ``Tensor.float`` leaves a float64 tensor as it is, so
    the statistics the port takes in float32 stay in float64."""
    to_float = torch.Tensor.float
    monkeypatch.setattr(torch.Tensor, "float",
                        lambda t: t if t.dtype == torch.float64 else to_float(t))
    cfg = vt.preset("notebook").discriminator.replace(
        num_features_conv1=4, num_features_res=(8, 8, 16), linear_widths=(8,))
    torch.manual_seed(0)
    critic = Discriminator(cfg, SIZE, dtype=torch.float64, remat=remat).double()
    return critic


def penalty_grads(critic):
    """The gradients, in every parameter of a copy of ``critic``, of its
    penalty at the interpolates of a fixed batch, taken in float64."""
    critic = copy.deepcopy(critic)
    g = torch.Generator().manual_seed(1)
    real, fake = (torch.rand(3, SIZE, SIZE, 1, dtype=torch.float64, generator=g)
                  for _ in range(2))
    alpha = torch.rand(3, 1, 1, 1, dtype=torch.float64, generator=g)
    interp = losses.interpolates(real, fake, alpha)
    logits = critic(interp, train=True, generator=torch.Generator().manual_seed(2))
    (gi,) = torch.autograd.grad(logits.sum(), interp, create_graph=True)
    pen = torch.mean((gi.flatten(1).norm(dim=1) - 1.0) ** 2)
    return torch.autograd.grad(pen, list(critic.parameters()), allow_unused=True)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_penalty_gradients_match_the_default_route(monkeypatch, default_route, remat):
    critic = float64_critic(monkeypatch, remat)
    got = penalty_grads(critic)
    with default_route:
        want = penalty_grads(critic)
    assert len(got) == len(want)
    scale = max(float(w.abs().max()) for w in want if w is not None)
    assert scale > 0
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert float((a - b).abs().max()) <= 1e-12 * scale


def step_cfg(**train) -> vt.Config:
    """The notebook's step at 16x16 with its full-architecture critic (10
    convolutions) and a cut generator."""
    cfg = vt.preset("notebook")
    return cfg.replace(
        generator=cfg.generator.replace(depth=1, feature_size=4),
        data=cfg.data.replace(image_size=SIZE, batch_size=BATCH),
        train=cfg.train.replace(**train))


def _recording(opt, module, store):
    named = list(module.named_parameters())
    inner = opt.step

    def step(*a, **k):
        store.update({n: p.grad.detach().clone() for n, p in named})
        return inner(*a, **k)

    opt.step = step


def run_step(cfg, state, do_gp=True, prof=False):
    """One G+D step on a copy of ``state``: its metrics, the gradients each
    optimizer stepped with, and a profile of the step where ``prof``."""
    state = copy.deepcopy(state)
    grads = {}
    _recording(state.opt_d, state.critic, grads)
    _recording(state.opt_g, state.generator, grads)
    batch = torch.rand(BATCH, SIZE, SIZE, 1, generator=torch.Generator().manual_seed(3))
    step = vt.make_train_step(cfg, True, do_gp=do_gp)
    if not prof:
        return step(state, batch, 7)[1], grads, None
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
        metrics = step(state, batch, 7)[1]
    return metrics, grads, p


@pytest.fixture(scope="module")
def notebook_state():
    return vt.create_train_state(step_cfg(), device="cpu", seed=0)


def test_step_matches_todays(notebook_state, default_route):
    """``tests/test_torch_train_step.py``'s tolerances: metrics 2e-4 relative
    + 1e-5; a gradient within 1e-3 of its tensor's largest plus 1e-5 of the
    generator's largest (1e-2 of the critic's)."""
    cfg = step_cfg()
    got_m, got_g, _ = run_step(cfg, notebook_state)
    with default_route:
        want_m, want_g, _ = run_step(cfg, notebook_state)
    assert got_m.keys() == want_m.keys()
    for k in want_m:
        assert float(got_m[k]) == pytest.approx(float(want_m[k]), rel=2e-4, abs=1e-5), k
    assert got_g.keys() == want_g.keys()
    for net, share in (("generator", 1e-5), ("critic", 1e-2)):
        names = [n for n, _ in getattr(notebook_state, net).named_parameters()]
        top = max(float(want_g[n].abs().max()) for n in names)
        for n in names:
            tol = 1e-3 * float(want_g[n].abs().max()) + share * top
            assert float((got_g[n] - want_g[n]).abs().max()) <= tol, n


def phase_of(event) -> str:
    """The innermost ``vaegan.step.*`` range around a profiler event."""
    e = event.cpu_parent
    while e is not None and not e.name.startswith(profiling.PREFIX + "step."):
        e = e.cpu_parent
    return "" if e is None else e.name[len(profiling.PREFIX):]


def conv_tally(prof):
    """Per phase: ``aten::convolution_backward`` calls, the dgrads and wgrads
    they compute (their output mask), the forward ``aten::_convolution``
    calls and those whose filter is larger than 3x3 (in the critic, the
    batch-swapped convolution's: ``gO`` at the activation's spatial size; the
    generator's transposed convolutions have 4x4 kernels)."""
    out = defaultdict(Counter)
    for e in prof.events():
        if e.name == "aten::convolution_backward":
            mask = e.concrete_inputs[-1]
            out[phase_of(e)].update(calls=1, dgrad=int(mask[0]), wgrad=int(mask[1]))
        elif e.name == "aten::_convolution":
            big = max(e.input_shapes[1][-2:]) > 3
            out[phase_of(e)].update(fwd=1, image_sized_filter=int(big))
    return out


@pytest.fixture(scope="module")
def tallies(notebook_state):
    """The step's convolutions per phase through the route and the default."""
    mp = pytest.MonkeyPatch()
    cfg = step_cfg()
    try:
        new = conv_tally(run_step(cfg, notebook_state, prof=True)[2])
        mp.setattr(conv, "conv2d", default_conv2d)
        old = conv_tally(run_step(cfg, notebook_state, prof=True)[2])
    finally:
        mp.undo()
    return new, old


SITES = 10


def test_inner_gradient_issues_no_more_convolution_backward(tallies):
    new, old = tallies
    d = new["step.d_forward"]
    assert d == old["step.d_forward"]
    assert d["calls"] == d["dgrad"] == SITES and d["wgrad"] == 0


def test_g_half_computes_todays_dgrads_and_wgrads(tallies):
    """The same dgrads and wgrads. The generator's encoder convolutions whose
    input requires a gradient compute theirs in two calls, dgrad and wgrad,
    where the default makes one call for both."""
    new, old = tallies
    g_new, g_old = new["step.g_half"], old["step.g_half"]
    assert (g_new["dgrad"], g_new["wgrad"]) == (g_old["dgrad"], g_old["wgrad"])
    assert g_new["fwd"] == g_old["fwd"]


def test_g_half_through_the_critic_issues_no_more_convolution_backward(
        notebook_state, default_route):
    """The G half's backward through the critic, to the generator's images:
    one dgrad a convolution and no wgrad, in both routes."""
    def tally():
        critic = copy.deepcopy(notebook_state.critic)
        imgs = torch.rand(BATCH, SIZE, SIZE, 1, requires_grad=True)
        logits = critic(imgs, train=True, generator=torch.Generator().manual_seed(4))
        with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as p:
            torch.autograd.grad(losses.wgan_generator_loss(logits), imgs)
        return conv_tally(p)[""]
    got = tally()
    with default_route:
        want = tally()
    assert got == want
    assert got["calls"] == got["dgrad"] == SITES and got["wgrad"] == 0


def test_critic_backward_has_no_image_sized_filter(tallies):
    new, old = tallies
    d_new, d_old = new["step.d_backward"], old["step.d_backward"]
    assert d_old["image_sized_filter"] == SITES      # the default's batch-swapped convs
    assert d_new["image_sized_filter"] == 0
    assert d_new["fwd"] == d_old["fwd"] - SITES
    assert d_new["wgrad"] == d_old["wgrad"] + SITES
    # the interpolates' first convolution: its input requires a gradient
    assert d_new["dgrad"] == d_old["dgrad"] + 1
    for phase in set(new) | set(old):
        if phase != "step.d_backward":
            assert new[phase] == old[phase] or phase == "step.g_half", phase


@pytest.mark.parametrize("do_gp,count", [(True, SITES), (False, 0)], ids=["gp", "no_gp"])
def test_penalty_wgrad_counts_each_critic_convolution(notebook_state, do_gp, count):
    critic = notebook_state.critic
    assert sum(isinstance(m, layers.Conv2D) for m in critic.modules()) == SITES
    profiling.clear()
    with profiling.tracing():
        run_step(step_cfg(), notebook_state, do_gp=do_gp)
    assert profiling.counts("conv.penalty_wgrad") == count
    profiling.clear()


def test_serving_counts_no_penalty_wgrad():
    cfg = step_cfg()
    state = vt.create_generator_state(cfg, device="cpu")
    profiling.clear()
    with profiling.tracing():
        inference.reconstruct(cfg, state, torch.rand(2, SIZE, SIZE, 1))
    assert profiling.counts("conv.penalty_wgrad") == 0
    assert [r.name for r in profiling.spans()] == ["serve.reconstruct"]
    profiling.clear()
