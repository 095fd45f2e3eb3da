"""PyTorch port, ``train/sweep.py``: ``interp_lambda``, ``gained_rd_curve``
against the JAX package's on the same weights and images, a one-lambda
``lambda_sweep`` and ``plot_rd_curve`` (CPU, M=16, K=1, one 192x192 image:
the default MS-SSIM needs 161 px a side)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_image_compression_tpu.models import GainedJointAR as JGained
from neural_image_compression_tpu.train.sweep import gained_rd_curve as jgained_rd_curve
from neural_image_compression_tpu.train.sweep import interp_lambda as jinterp_lambda
from neural_image_compression_tpu_torch.models import GainedJointAR, JointAutoregressiveHierarchical
from neural_image_compression_tpu_torch.train import (
    gained_rd_curve, interp_lambda, lambda_sweep, plot_rd_curve,
)
from neural_image_compression_tpu_torch.train import trainer as trainer_module
from neural_image_compression_tpu_torch.utils.weights import load_jax_params

torch.set_num_threads(1)

M = 16
LEVELS = (0.001, 0.005, 0.02)
# gain_y / gain_z grow 2x a level here (the model tests grow them 4x): at
# 16x the K=1 model puts latents in the upper tail of their Gaussians,
# where the two packages' erf round the CDFs to neighbouring floats and a
# latent costs 23 or 30 bits, which moves the level-2 bpp by 1%. At 4x
# (level 2 here) none is there, and the two curves' bpp agree to 4e-7.
GROWTH = 2.0
# bpp: float32 sums in other orders; PSNR: x_hat within 1e-6; MS-SSIM: both
# packages sit up to 4e-6 from float64 on a random model's reconstructions
BPP_RTOL, PSNR_ATOL, MSSSIM_ATOL = 1e-5, 1e-4, 1e-5


def gained_params(jmodel, seed=1):
    key = jax.random.PRNGKey(0)
    params = jax.tree.map(np.array, jmodel.init({"params": key, "noise": key},
                                                jnp.zeros((1, 64, 64, 3)),
                                                training=False)["params"])
    rng = np.random.RandomState(seed)
    for k in ("gain_y", "igain_y", "gain_z", "igain_z"):
        r = 0.3 + rng.rand(*params[k].shape).astype(np.float32) * 2.0
        if k in ("gain_y", "gain_z"):
            r = r * (GROWTH ** np.arange(r.shape[0], dtype=np.float32))[:, None]
        params[k] = r
    return params


@pytest.fixture(scope="module")
def rig():
    jmodel = JGained(latent_channels=M, K=1, levels=LEVELS)
    params = gained_params(jmodel)
    model = load_jax_params(GainedJointAR(M, 1, LEVELS, device="cpu"), params)
    loader = [np.random.default_rng(9).uniform(size=(1, 192, 192, 3)).astype(np.float32)]
    return jmodel, params, model, loader


@pytest.mark.parametrize("level", [0, 0.5, 1, 1.7, 2, -1, 5])
def test_interp_lambda_matches_jax(level):
    assert interp_lambda(LEVELS, level) == jinterp_lambda(LEVELS, level)


def test_interp_lambda_is_geometric():
    assert interp_lambda(LEVELS, 0.5) == pytest.approx((LEVELS[0] * LEVELS[1]) ** 0.5)
    assert interp_lambda(LEVELS, 2) == pytest.approx(LEVELS[2])


def test_gained_rd_curve_matches_jax(rig, tmp_path):
    jmodel, params, model, loader = rig
    levels = (0, 1.5, 2)
    got = gained_rd_curve(model, loader, levels=levels, out_dir=str(tmp_path))
    want = jgained_rd_curve(jmodel, params, loader, levels=levels)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert list(g) == list(w) == ["lambda", "level", "bpp", "psnr", "msssim"]
        assert g["lambda"] == w["lambda"] and g["level"] == w["level"]
        assert g["bpp"] == pytest.approx(w["bpp"], rel=BPP_RTOL)
        assert g["psnr"] == pytest.approx(w["psnr"], abs=PSNR_ATOL)
        assert g["msssim"] == pytest.approx(w["msssim"], abs=MSSSIM_ATOL)
    assert [p["bpp"] for p in got] == sorted(p["bpp"] for p in got)
    with open(tmp_path / "rd_curve.json") as f:
        assert json.load(f) == got


def test_gained_rd_curve_default_levels(rig):
    """The integer ladder by default, the model left as it was."""
    _, _, model, loader = rig
    before = {k: v.clone() for k, v in model.state_dict().items()}
    pts = gained_rd_curve(model, loader)
    assert sorted(p["level"] for p in pts) == [0.0, 1.0, 2.0]
    assert sorted(p["lambda"] for p in pts) == pytest.approx(list(LEVELS))
    assert all(np.isfinite(p[k]) for p in pts for k in ("bpp", "psnr", "msssim"))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_lambda_sweep_one_lambda(tmp_path, rig, monkeypatch):
    _, _, _, loader = rig
    train = [np.random.default_rng(3).uniform(size=(2, 64, 64, 3)).astype(np.float32)]
    out_dir = str(tmp_path / "sweep")
    pts = lambda_sweep(lambda: JointAutoregressiveHierarchical(M, 1, device="cpu"), train,
                       loader, [0.01], max_steps=2, out_dir=out_dir)
    assert len(pts) == 1 and list(pts[0]) == ["lambda", "bpp", "psnr", "msssim"]
    assert pts[0]["lambda"] == 0.01
    assert all(np.isfinite(pts[0][k]) for k in ("bpp", "psnr", "msssim"))
    with open(os.path.join(out_dir, "rd_curve.json")) as f:
        assert json.load(f) == pts
    assert os.path.isfile(os.path.join(out_dir, "ckpt", "lambda_0.01.pt"))
    assert os.path.isfile(os.path.join(out_dir, "runs", "lambda_0.01", "metrics.jsonl"))
    # a mesh goes to each run's Trainer (the data-parallel runs are
    # test_torch_multiprocess.py's)
    meshes = []

    def trainer_with_mesh(*args, mesh=None, **kwargs):
        meshes.append(mesh)
        raise RuntimeError("stop after the Trainer's arguments")

    monkeypatch.setattr(trainer_module, "Trainer", trainer_with_mesh)
    mesh = object()
    with pytest.raises(RuntimeError, match="stop after"):
        lambda_sweep(lambda: None, train, loader, [0.01], max_steps=1, out_dir=out_dir, mesh=mesh)
    assert meshes == [mesh]


def test_plot_rd_curve_writes_a_png(tmp_path):
    pts = [{"bpp": 0.1, "psnr": 28.0, "msssim": 0.9}, {"bpp": 0.3, "psnr": 31.5, "msssim": 0.95}]
    path = str(tmp_path / "rd.png")
    assert plot_rd_curve(pts, path) == path
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert plot_rd_curve(pts, str(tmp_path / "ms.png"), metric="msssim").endswith("ms.png")
