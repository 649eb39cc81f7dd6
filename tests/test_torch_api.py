"""The port's API surface and utilities, on the CPU: ``experiment`` and
``visualize_reconstructions``, ``inference.save_visual_evidence``, the metric
sinks (the reference's stdout line against the JAX package's, character for
character; the Neptune channels), the logger's one host transfer per flush,
``make_grid`` against the JAX package's bitwise, and the profiling helpers."""

from __future__ import annotations

import http.client
import io
import json
import math
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from vaegan_tpu.utils import imaging as jimaging
from vaegan_tpu.utils import metrics as jmetrics
import vaegan_tpu_torch as vt
from vaegan_tpu_torch.data import pipeline
from vaegan_tpu_torch.utils import imaging, metrics, profiling

# the suite runs files in parallel workers; one intra-op thread each keeps
# torch from taking every core from the other workers
torch.set_num_threads(1)

TINY = dict(network_depth=1, network_length=1, feature_size=8,
            discriminator_params=dict(num_stride_conv1=1, num_features_conv1=8, num_blocks=[1],
                                      num_strides_res=[2], num_features_res=[16]),
            n_epochs=1, image_size=16, batch_size=4, synthetic_data=True)
CHANNELS = ("D loss", "G loss", "Recon loss", "KL", "D Real loss", "D Fake loss",
            "adversarial loss")


def small_loader(n=8):
    return pipeline.DataLoader(pipeline.SyntheticDataset(n, 16), 4, shuffle=False,
                               prefetch_batches=0)


class FakeRun(dict):
    stopped = False

    def __getitem__(self, k):
        return self.setdefault(k, [])

    def stop(self):
        self.stopped = True


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``experiment()`` on the CPU with a Neptune-style run object."""
    tmp = tmp_path_factory.mktemp("exp")
    mp = pytest.MonkeyPatch()
    mp.chdir(tmp)               # the default sample folder is ./gan_inference
    try:
        run = FakeRun()
        state, cfg = vt.experiment(**TINY, loader=small_loader(), neptune_run=run, device="cpu")
    finally:
        mp.undo()
    return {"state": state, "cfg": cfg, "run": run, "tmp": tmp}


def test_experiment_trains_and_streams_the_reference_channels(trained):
    state, cfg, run = trained["state"], trained["cfg"], trained["run"]
    assert state.step == 2 and cfg.data.image_size == 16 and cfg.generator.depth == 1
    assert cfg.discriminator.num_blocks == (1,)
    assert run.stopped
    for ch in CHANNELS:
        assert len(run[ch]) == 2 and all(math.isfinite(v) for v in run[ch]), ch
    assert sorted(p.name for p in (trained["tmp"] / "gan_inference").iterdir()) == ["0.png"]


def test_experiment_refuses_kwargs_beside_config_overrides(trained):
    with pytest.raises(ValueError, match="ambiguous"):
        vt.experiment(config_overrides=trained["cfg"], lr=1e-3, device="cpu")


def test_visualize_reconstructions(trained, tmp_path, capsys):
    mse = vt.visualize_reconstructions(trained["cfg"], trained["state"], small_loader(),
                                       num_images=4, out_path=str(tmp_path / "recon.png"))
    assert np.isfinite(mse)
    assert "Mean squared error between original and reconstructed images" in capsys.readouterr().out
    from PIL import Image
    assert Image.open(tmp_path / "recon.png").size == (4 * 18 + 2, 2 * 18 + 2)


def test_save_visual_evidence_writes_all_three(trained, tmp_path):
    batch = pipeline.SyntheticDataset(8, 16).load_batch(range(8))
    written = vt.save_visual_evidence(trained["cfg"], trained["state"], batch, tmp_path,
                                      generator=torch.Generator().manual_seed(1), prefix="x_")
    assert set(written) == {"recon_panel", "samples", "interpolation"}
    for name, path in written.items():
        p = Path(path)
        assert p.exists() and p.stat().st_size > 0 and p.name.startswith("x_"), name


# ---------------------------------------------------------------- sinks
METRICS = {"d_loss": -1.23456, "g_loss": 12.5, "recon_loss": 0.0004, "kl": 1874.9999,
           "d_real_loss": 0.5, "d_fake_loss": -0.25, "adv_loss": float("nan"), "gp": 3.0}


def test_stdout_line_matches_jax_character_for_character():
    port, ref = io.StringIO(), io.StringIO()
    metrics.StdoutSink(port).write(1, 3, 7, 300, METRICS)
    jmetrics.StdoutSink(ref).write(1, 3, 7, 300, METRICS)
    assert port.getvalue() == ref.getvalue()
    assert port.getvalue().startswith("[Epoch 1/3] [Batch 7/300] [D loss: -1.235]")


def test_logged_tensors_reach_the_sinks_as_the_jax_logger_writes_them(tmp_path):
    port, ref = io.StringIO(), io.StringIO()
    logger = metrics.MetricsLogger(sinks=[metrics.StdoutSink(port),
                                          metrics.JsonlSink(str(tmp_path / "m.jsonl"))],
                                   flush_every=2)
    jlogger = jmetrics.MetricsLogger(sinks=[jmetrics.StdoutSink(ref)], flush_every=2)
    for i in range(3):
        m = {k: v + i for k, v in METRICS.items()}
        logger.log(0, 1, i, 3, {k: torch.tensor(v, dtype=torch.float32) for k, v in m.items()})
        jlogger.log(0, 1, i, 3, {k: np.float32(v) for k, v in m.items()})
    logger.close()
    jlogger.close()
    assert port.getvalue() == ref.getvalue() and len(port.getvalue().splitlines()) == 3
    rec = json.loads((tmp_path / "m.jsonl").read_text().splitlines()[0])
    assert {"D loss", "G loss", "Recon loss", "KL", "D Real loss", "D Fake loss",
            "adversarial loss", "gp", "epoch", "batch", "ts"} == set(rec)
    assert logger.history[2]["g_loss"] == jlogger.history[2]["g_loss"] == 14.5


def test_flush_copies_to_the_host_once_and_log_never(monkeypatch):
    copies = []
    real_cpu = torch.Tensor.cpu

    def counting_cpu(self, *a, **k):
        copies.append(tuple(self.shape))
        return real_cpu(self, *a, **k)

    def refuse(self, *a, **k):
        raise AssertionError("a per-value host sync")

    logger = metrics.MetricsLogger(sinks=[], flush_every=4)
    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    monkeypatch.setattr(torch.Tensor, "__float__", refuse)
    monkeypatch.setattr(torch.Tensor, "item", refuse)
    for i in range(3):
        logger.log(0, 1, i, 4, {"d_loss": torch.tensor(float(i)), "g_loss": torch.tensor(1.0)})
    assert copies == [] and logger.history == []
    logger.log(0, 1, 3, 4, {"d_loss": torch.tensor(3.0), "g_loss": torch.tensor(1.0)})
    assert copies == [(8,)]
    assert [m["d_loss"] for m in logger.history] == [0.0, 1.0, 2.0, 3.0]


def test_neptune_sink_streams_the_reference_channels():
    run = FakeRun()
    sink = metrics.NeptuneSink(run)
    sink.write(0, 1, 0, 1, {k: 1.0 for k in metrics.REFERENCE_KEYS} | {"gp": 2.0})
    sink.close()
    assert run.stopped and sorted(run) == sorted(CHANNELS)
    assert metrics.REFERENCE_KEYS == jmetrics.REFERENCE_KEYS


# ---------------------------------------------------------------- grids
@pytest.mark.parametrize("n,nrow,normalize", [(25, 5, True), (7, 3, True), (4, 5, False)])
def test_make_grid_matches_jax_bitwise(n, nrow, normalize, tmp_path):
    imgs = np.random.default_rng(n).normal(size=(n, 9, 11, 1)).astype(np.float32)
    want = jimaging.make_grid(imgs, nrow=nrow, normalize=normalize)
    np.testing.assert_array_equal(imaging.make_grid(imgs, nrow=nrow, normalize=normalize), want)
    np.testing.assert_array_equal(imaging.make_grid(torch.from_numpy(imgs), nrow=nrow,
                                                    normalize=normalize), want)
    imaging.save_image_grid(torch.from_numpy(imgs), str(tmp_path / "p.png"), nrow=nrow)
    jimaging.save_image_grid(imgs, str(tmp_path / "j.png"), nrow=nrow)
    assert (tmp_path / "p.png").read_bytes() == (tmp_path / "j.png").read_bytes()


# ---------------------------------------------------------------- profiling
def test_profiling_trace_annotate_timer_and_no_server(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        with profiling.annotate("port-step"):
            torch.ones(8).sum()
    assert "port-step" in (tmp_path / "tr" / "trace.json").read_text()
    timer = profiling.StepTimer(warmup=1)
    for _ in range(3):
        timer.tick(torch.tensor(1.0))
    out = timer.result(4, torch.tensor(1.0))
    assert out["steps_per_sec"] > 0 and out["images_per_sec"] == pytest.approx(4 * out["steps_per_sec"])
    assert profiling.StepTimer(warmup=5).result(4)["images_per_sec"] == 0.0


def _get(port, path):
    """(status, JSON body) of a GET to the local endpoint (no proxy between)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def test_profiling_server_captures_another_threads_ops(tmp_path, monkeypatch):
    """``start_server(0)``: a capture of 200 ms holds the aten ops of a worker
    thread (not the server's), under the log directory fixed at start; a second
    start raises; a bad duration is refused, a failed capture answered with
    500; ``stop()`` frees the port."""
    server = profiling.start_server(0, str(tmp_path / "prof"))
    try:
        assert server.log_dir == str(tmp_path / "prof") and server.port > 0
        with pytest.raises(RuntimeError, match="already running"):
            profiling.start_server(0)
        stop, tid = threading.Event(), []

        def work():
            tid.append(threading.get_native_id())
            a = torch.ones(64, 64)
            while not stop.is_set():
                torch.mm(a, a)

        worker = threading.Thread(target=work)
        worker.start()
        try:
            status, out = _get(server.port, "/capture?duration_ms=200")
        finally:
            stop.set()
            worker.join()
        assert status == 200
        assert out["path"] == str(tmp_path / "prof" / "capture_1" / "trace.json")
        assert out["cpu_events"] > 0 and out["device_events"] == 0
        events = json.loads(Path(out["path"]).read_text())["traceEvents"]
        assert any(e.get("name") == "aten::mm" and e.get("tid") == tid[0] for e in events)
        assert _get(server.port, "/capture?duration_ms=0")[0] == 400
        assert _get(server.port, "/elsewhere")[0] == 404

        def fail(*args):
            raise RuntimeError("the profiler is busy")

        monkeypatch.setattr(profiling, "capture", fail)
        assert _get(server.port, "/capture?duration_ms=1") == (
            500, {"error": "RuntimeError: the profiler is busy"})
    finally:
        server.stop()
    assert profiling._SERVER is None
    profiling.start_server(server.port, str(tmp_path / "again")).stop()   # the port is free
    with pytest.raises(RuntimeError, match="no profiler server"):
        profiling.stop_server()
