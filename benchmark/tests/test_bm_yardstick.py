"""The counts the per-layer metrics divide by, against hand counts."""

import pytest


def _tiny_cfg():
    from vaegan_tpu_torch.config import preset
    c = preset("notebook")
    g = c.generator.replace(depth=1, length=1, feature_size=2)
    return c.replace(generator=g, data=c.data.replace(image_size=4)).to_dict()


def test_reconstruct_flops_by_hand():
    from harness import yardstick
    cfg, b, s = _tiny_cfg(), 3, 4
    # 2 * batch * output pixels * out * in * k * k, per convolution
    conv = lambda cin, cout, out_px, k: 2 * b * out_px * cout * cin * k * k  # noqa: E731
    enc = conv(1, 2, 16, 3) * 2 + conv(2, 2, 16, 3)                  # level 1->2: conv1, shortcut, conv2
    down = conv(2, 4, 4, 3) * 2 + conv(4, 4, 4, 3)                   # downsample 2->4 at stride 2
    head = conv(4, 4, 4, 3)                                         # mu (log_var is counted too)
    up = 2 * b * 4 * 4 * 2 * 16 * 2 + conv(2, 2, 16, 3)              # transposed 4x4: in px * in * out * 16
    rec = conv(2, 1, 16, 3) * 2 + conv(1, 1, 16, 3)                  # reconstruction 2->1
    assert yardstick.reconstruct_flops(cfg, b) == enc + down + 2 * head + up + rec


def test_kernel_bytes_and_ops_by_hand():
    from harness import yardstick
    # a BN site of 2 x 8 x 4 x 4 float32 with dropout: x read, y written, four
    # float32 channel vectors read; 6 + 25 + 5 operations an element
    n, c = 2 * 8 * 4 * 4, 8
    assert yardstick.kernel_cost("bn_act_dropout", n, c, 4, True) == (2 * n * 4 + 16 * c, 36 * n)
    # its backward in bfloat16: x, g read, dx written, 8 channel words a channel
    assert yardstick.kernel_cost("bn_act_dropout_bwd", n, c, 2, False) == (3 * n * 2 + 32 * c,
                                                                          14 * n)
    assert yardstick.kernel_cost("recon_loss_sums", 100, 0, 4, False) == (808, 500)
    bound = yardstick.kernel_bound_s("bn_act_dropout", n, c, 4, True)
    assert bound == pytest.approx(max((2 * n * 4 + 16 * c) / 3.35e12, 36 * n / 67e12))


def test_roofline_share_from_calls_and_events():
    from harness import yardstick
    from harness.trace import TraceShort
    calls = [("recon_loss_sums", 1000, 0, 4, False)] * 4
    bound = yardstick.kernel_bound_s("recon_loss_sums", 1000, 0, 4, False)
    events = {"void recon_sums_kernel<float>(...)": [8 * bound, 4]}
    assert yardstick.fused_roofline(calls, events) == pytest.approx(50.0)
    events = {"void recon_sums_kernel<float>(...)": [2 * bound, 2]}    # half the events
    assert yardstick.fused_roofline(calls, events) == pytest.approx(100.0)
    with pytest.raises(TraceShort):
        yardstick.fused_roofline(calls, {"void recon_sums_kernel<float>(...)": [bound, 1]})


def test_a_kernel_run_without_a_recorded_launch_fails():
    from harness import yardstick
    from harness.trace import TraceShort
    calls = [("recon_loss_sums", 1000, 0, 4, False)]
    bound = yardstick.kernel_bound_s("recon_loss_sums", 1000, 0, 4, False)
    events = {"void recon_sums_kernel<float>(...)": [2 * bound, 1]}
    fn = yardstick.DEVICE_NAMES["bn_act_dropout"]
    with pytest.raises(TraceShort):
        yardstick.fused_roofline(calls, dict(events, **{f"void {fn}<float>(...)": [bound, 3]}))
