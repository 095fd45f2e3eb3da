"""PyTorch port, the evaluation and training tools around the Trainer and
the evaluator, each held against its JAX counterpart where one exists
(CPU): bd_rate / bd_psnr, curve_health, classical_rd_curve, the datasets
and BatchLoader (batches, shuffle order, prefetch shutdown, a producer's
error), pad_to_multiple / center_crop, the metrics logger, checkpoints
(atomic write, keys), profiling.trace and StepTimer, the viz plots."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from neural_image_compression_tpu.data import datasets as jdata
from neural_image_compression_tpu.evaluation import anchors as janchors
from neural_image_compression_tpu.evaluation import bdrate as jbdrate
from neural_image_compression_tpu.evaluation import health as jhealth
from neural_image_compression_tpu.utils import profiling as jprofiling
from neural_image_compression_tpu_torch import data
from neural_image_compression_tpu_torch.evaluation import (
    bd_psnr, bd_rate, classical_rd_curve, curve_health, plot_information_evolution,
    plot_metric_evolution,
)
from neural_image_compression_tpu_torch.train import metrics_logger
from neural_image_compression_tpu_torch.train.metrics_logger import (
    JsonlSink, MetricsLogger, NullLogger, host_scalars,
)
from neural_image_compression_tpu_torch.utils import checkpoint, profiling

torch.set_num_threads(1)

ANCHOR = [(0.25, 28.0), (0.5, 31.0), (1.0, 34.5), (2.0, 38.0)]
TEST = [{"bpp": 0.2, "psnr": 28.6}, {"bpp": 0.45, "psnr": 31.9}, {"bpp": 0.9, "psnr": 35.0},
        {"bpp": 1.7, "psnr": 38.2}, {"bpp": 1.8, "psnr": 38.1}]


@pytest.mark.parametrize("fn, jfn", [(bd_rate, jbdrate.bd_rate), (bd_psnr, jbdrate.bd_psnr)],
                         ids=["bd_rate", "bd_psnr"])
def test_bd_metrics_match_jax(fn, jfn):
    assert fn(ANCHOR, TEST) == jfn(ANCHOR, TEST)
    assert fn(TEST, ANCHOR) == jfn(TEST, ANCHOR)
    assert fn(ANCHOR, ANCHOR) == 0.0
    with pytest.raises(ValueError, match="overlap"):
        fn(ANCHOR, [(10.0, 50.0), (20.0, 60.0)])


def test_curve_health_matches_jax():
    points = [{"lambda": 0.0025, "bpp": 0.2, "psnr": 28.0},
              {"lambda": 0.005, "bpp": 0.35, "psnr": 29.5},
              {"lambda": 0.01, "bpp": 0.3, "psnr": 29.3},
              {"lambda": 0.02, "bpp": 0.9, "psnr": 29.35}]
    got = curve_health(points)
    assert got == jhealth.curve_health(points) and len(got) >= 2
    assert curve_health(points[:2]) == [] == jhealth.curve_health(points[:2])


def _images(n, h, w, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8) for _ in range(n)]


def test_classical_rd_curve_matches_jax():
    pytest.importorskip("PIL")
    imgs = _images(2, 176, 192, 0)
    got = classical_rd_curve(imgs, "jpeg", qualities=(30, 80), with_msssim=True, device="cpu")
    want = janchors.classical_rd_curve(imgs, "jpeg", qualities=(30, 80), with_msssim=True)
    assert [{k: v for k, v in p.items() if k != "msssim"} for p in got] == \
        [{k: v for k, v in p.items() if k != "msssim"} for p in want]
    np.testing.assert_allclose([p["msssim"] for p in got], [p["msssim"] for p in want],
                               rtol=0, atol=5e-6)  # test_torch_msssim.py's bound
    webp = classical_rd_curve([imgs[0].astype(np.float32)[None] / 255], "webp", qualities=(50,))
    assert webp == janchors.classical_rd_curve([imgs[0].astype(np.float32)[None] / 255], "webp",
                                               qualities=(50,))
    with pytest.raises(ValueError, match="codec"):
        classical_rd_curve(imgs, "png")


def _write_pngs(root, n, size, seed, ext="png"):
    from PIL import Image

    os.makedirs(root, exist_ok=True)
    for i, img in enumerate(_images(n, size[0], size[1], seed)):
        Image.fromarray(img).save(os.path.join(root, f"img_{i:02d}.{ext}"))


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_datasets_match_jax(tmp_path, dtype):
    pytest.importorskip("PIL")
    _write_pngs(tmp_path, 3, (40, 56), 1)
    _write_pngs(tmp_path, 2, (40, 56), 2, ext="jpg")
    got, want = data.ImageFolderDataset(str(tmp_path), dtype), \
        jdata.ImageFolderDataset(str(tmp_path), dtype)
    assert len(got) == len(want) == 5
    for i in range(5):
        assert np.array_equal(got[i], want[i]) and got[i].dtype == dtype
    assert len(data.KodakDataset(str(tmp_path))) == 3
    cached = data.ImageFolderDataset(str(tmp_path), dtype, cache=True)
    assert cached[0] is cached[0] and not cached[0].flags.writeable


@pytest.mark.parametrize("shuffle, drop, prefetch", [(True, True, 2), (True, False, 0),
                                                     (False, False, 1)])
def test_batch_loader_matches_jax(shuffle, drop, prefetch):
    """The same batches in the same order over three passes (the shuffle
    draws one permutation a pass from RandomState(seed))."""
    items = [np.full((4, 6, 3), i, np.float32) for i in range(7)]
    kw = dict(batch_size=3, shuffle=shuffle, drop_remainder=drop, seed=5, prefetch=prefetch)
    got, want = data.BatchLoader(items, **kw), jdata.BatchLoader(items, **kw)
    assert len(got) == len(want)
    for _ in range(3):
        a, b = list(got), list(want)
        assert len(a) == len(b) == len(want)
        for x, y in zip(a, b):
            assert np.array_equal(x, y)
    padded = data.BatchLoader(items, batch_size=2, pad_multiple=8, prefetch=0)
    assert next(iter(padded)).shape == (2, 8, 8, 3)


def test_batch_loader_prefetch_stops_when_abandoned():
    """An iterator abandoned mid-pass (the Trainer stops at max_steps) lets
    its producer thread end although the queue is full."""
    items = [np.zeros((2, 2, 3), np.float32)] * 50
    before = set(threading.enumerate())
    it = iter(data.BatchLoader(items, batch_size=1, prefetch=2))
    next(it)
    time.sleep(0.3)  # the producer fills the queue and blocks on it
    started = [t for t in set(threading.enumerate()) - before if "producer" in t.name]
    assert len(started) == 1 and started[0].is_alive()
    it.close()
    thread = started[0]
    thread.join(timeout=5)
    assert not thread.is_alive()


class _Broken:
    def __len__(self):
        return 4

    def __getitem__(self, i):
        if i == 2:
            raise OSError("image 2 does not decode")
        return np.zeros((2, 2, 3), np.float32)


def test_batch_loader_producer_error_reaches_consumer():
    it = iter(data.BatchLoader(_Broken(), batch_size=1, prefetch=2))
    assert next(it).shape == (1, 2, 2, 3)
    assert next(it).shape == (1, 2, 2, 3)
    with pytest.raises(OSError, match="does not decode"):
        next(it)


def test_pad_and_crop_match_jax():
    x = np.random.default_rng(3).uniform(size=(2, 100, 130, 3)).astype(np.float32)
    got, want = data.pad_to_multiple(x, 64), jdata.pad_to_multiple(x, 64)
    assert got.shape == (2, 128, 192, 3) and np.array_equal(got, want)
    assert data.pad_to_multiple(got, 64) is got
    assert np.array_equal(data.center_crop(got, 100, 130), x)
    assert np.array_equal(data.center_crop(got, 100, 130), jdata.center_crop(want, 100, 130))


def test_host_scalars_one_transfer_and_order(monkeypatch):
    metrics = {"loss": torch.tensor(1.5), "per_image": torch.ones(3), "bpp": torch.tensor(0.25),
               "n": 3, "lr": np.float32(0.5), "arr": np.ones(2)}
    copies = []
    cpu = torch.Tensor.cpu
    monkeypatch.setattr(torch.Tensor, "cpu", lambda t: copies.append(t.shape) or cpu(t))
    got = host_scalars(metrics)
    assert copies == [(2,)]  # both 0-dim tensors in one copy
    assert got == {"loss": 1.5, "bpp": 0.25, "n": 3.0, "lr": 0.5}
    assert list(got) == ["loss", "bpp", "n", "lr"]
    assert host_scalars({"a": torch.tensor(2.0, dtype=torch.bfloat16)}) == {"a": 2.0}


def test_metrics_logger_jsonl(tmp_path, monkeypatch):
    log = MetricsLogger(str(tmp_path), tensorboard=False)
    log.scalars({"loss": torch.tensor(2.0), "img": torch.ones(2)}, 3, prefix="losses/")
    log.scalar("x", float("nan"), 4)
    log.histogram("h", np.ones(3), 4)
    log.close()
    rows = [json.loads(line) for line in open(tmp_path / "metrics.jsonl")]
    assert rows == [{"step": 3, "tag": "losses/loss", "value": 2.0},
                    {"step": 4, "tag": "x", "value": "nan"}]
    NullLogger().scalars({"a": 1}, 0)


def test_metrics_logger_without_tensorboard_writes_jsonl(tmp_path, monkeypatch):
    """Where tensorboard cannot be imported the logger writes JSONL alone."""
    def no_tensorboard(*args, **kwargs):
        raise ImportError("No module named 'tensorboard'")

    monkeypatch.setattr(metrics_logger, "TensorBoardSink", no_tensorboard)
    log = MetricsLogger(str(tmp_path))
    assert [type(s) for s in log.sinks] == [JsonlSink]
    log.scalar("a", 1.0, 0)
    log.close()
    assert os.listdir(tmp_path) == ["metrics.jsonl"]


def test_checkpoint_roundtrip_keys_and_atomic_write(tmp_path, monkeypatch):
    path = str(tmp_path / "sub" / "ckpt.pt")
    assert not checkpoint.checkpoint_exists(path)
    state = {"model": {"w": torch.arange(4.0)}, "rng": torch.Generator().get_state()}
    checkpoint.save_checkpoint(path, state, {"step": 7, "plateau": {"best": float("inf")}})
    assert checkpoint.checkpoint_exists(path) and os.listdir(tmp_path / "sub") == ["ckpt.pt"]
    got, aux = checkpoint.restore_checkpoint(path)
    assert aux == {"step": 7, "plateau": {"best": float("inf")}}
    assert torch.equal(got["model"]["w"], state["model"]["w"])
    assert torch.equal(got["rng"], state["rng"])
    assert checkpoint.checkpoint_keys(path) == {"model", "rng"}

    def interrupted(obj, f, *args, **kwargs):
        with open(f, "wb") as fh:
            fh.write(b"partial")
        raise KeyboardInterrupt  # preempted mid-write

    monkeypatch.setattr(torch, "save", interrupted)
    with pytest.raises(KeyboardInterrupt):
        checkpoint.save_checkpoint(path, {"model": {}}, {"step": 8})
    _, aux = checkpoint.restore_checkpoint(path)  # the previous checkpoint, whole
    assert aux["step"] == 7


def test_checkpoint_refuses_code(tmp_path):
    """Loading runs no pickled code (weights_only)."""
    path = str(tmp_path / "ckpt.pt")
    torch.save({"state": {"f": print}, "aux": None}, path)
    with pytest.raises(Exception, match="[Ww]eights only"):
        checkpoint.restore_checkpoint(path)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / files[0]) as f:
        assert "traceEvents" in json.load(f)


def test_step_timer_matches_jax(monkeypatch):
    """The same summary from the same clock readings."""
    summaries = []
    for module in (profiling, jprofiling):
        ticks = iter([0.0, 0.5, 1.0, 1.25, 2.0, 2.75, 3.0, 3.1])
        monkeypatch.setattr(module.time, "perf_counter", lambda: next(ticks))
        timer = module.StepTimer()
        barriers = []
        for _ in range(4):
            with timer.step(barrier=lambda: barriers.append(1)):
                pass
        assert len(barriers) == 4
        summaries.append(timer.summary())
    assert summaries[0] == summaries[1]
    assert summaries[0]["steps"] == 4 and summaries[0]["p50_s"] == 0.5
    assert profiling.StepTimer().summary() == {}


def test_viz_plots_write_pngs(tmp_path):
    pytest.importorskip("matplotlib")
    series = [(i, 1.0 / (i + 1)) for i in range(10)]
    p1 = plot_metric_evolution(series, "bpp", save_path=str(tmp_path / "m.png"))
    p2 = plot_information_evolution(series, [(s, v / 2) for s, v in series],
                                    save_path=str(tmp_path / "i.png"))
    for p in (p1, p2):
        assert os.path.getsize(p) > 0
