"""A run on the CPU, with the look for a card skipped: sound, it comes out
correct; with the timed path broken underneath, it comes out not correct,
once for each fault a cell can have (a step that returns its state
unchanged, half the batch left out with the mean over the rest, an answer
altered where it is produced). The cells run on one chip, so none has an
exchange between chips to leave out."""

import pytest
import torch

from port_bench.tests.tiny import run_on_cpu


@pytest.mark.parametrize("cell", ["gm128k3.train_f32_b16", "gm128k3.serve_bf16_kodak24",
                                  "scal192.train_f32_b16", "scal192.serve_bf16_kodak24"])
def test_sound_run_is_correct(monkeypatch, cell):
    rc, result = run_on_cpu(monkeypatch, cell)
    assert rc == 0 and result["correct"] is True, result
    assert result["failed"] == 0 and result["attempted"] > 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("cell", ["gm128k3.train_f32_b16", "scal192.train_f32_b16"])
def test_step_that_leaves_the_state_unchanged_is_caught(monkeypatch, cell):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)
    rc, result = run_on_cpu(monkeypatch, cell)
    assert rc == 0 and result["correct"] is False
    assert result["checks"]["step_median_rel"]["value"] > 0.5  # no leaf moved


@pytest.mark.parametrize("cell", ["gm128k3.train_f32_b16", "scal192.train_f32_b16"])
def test_step_on_half_the_batch_is_caught(monkeypatch, cell):
    from neural_image_compression_tpu_torch.parallel import train_step

    real = train_step.make_train_step

    def half_batch(*args, **kwargs):
        step = real(*args, **kwargs)
        return lambda batch, generator=None: step(batch[: batch.shape[0] // 2], generator)

    monkeypatch.setattr(train_step, "make_train_step", half_batch)
    rc, result = run_on_cpu(monkeypatch, cell)
    assert rc == 0 and result["correct"] is False


@pytest.mark.parametrize("cell", ["gm128k3.serve_bf16_kodak24", "scal192.serve_bf16_kodak24"])
def test_altered_answer_is_caught(monkeypatch, cell):
    from neural_image_compression_tpu_torch import serving

    real = serving.make_serving_fn

    def altered(model):
        serve = real(model)

        def run(x):
            out = dict(serve(x))
            x_hat = out["x_hat"].clone()
            x_hat[0] = torch.clamp(x_hat[0] + 0.05, 0.0, 1.0)
            return dict(out, x_hat=x_hat)
        return run

    monkeypatch.setattr(serving, "make_serving_fn", altered)
    rc, result = run_on_cpu(monkeypatch, cell)
    assert rc == 0 and result["correct"] is False
    assert result["checks"]["x_hat_rel"]["value"] > result["checks"]["x_hat_rel"]["limit"]


def test_traced_run_reports_device_and_breakdown(monkeypatch):
    rc, result = run_on_cpu(monkeypatch, "scal192.train_f32_b16", trace=1)
    assert rc == 0 and result["correct"] is True
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device operations on the CPU: nothing to read for the device's metrics
    assert "conv_ms.distill" not in result["metrics"] and "distill_host_ms" in result["metrics"]
