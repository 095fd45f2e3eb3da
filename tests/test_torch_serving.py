"""PyTorch port, serving path: rd_loss and make_serving_fn against the JAX
package, the port's import graph and its device defaults (CPU)."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_image_compression_tpu import serving as jserving
from neural_image_compression_tpu.models import JointAutoregressiveHierarchical as JModel
from neural_image_compression_tpu.train import rd_loss as jrd_loss
from neural_image_compression_tpu_torch import serving
from neural_image_compression_tpu_torch.models import JointAutoregressiveHierarchical
from neural_image_compression_tpu_torch.train import rd_loss
from neural_image_compression_tpu_torch.utils.weights import load_jax_params

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")
RD_KEYS = ("loss", "bpp_y", "bpp_z", "bpp_total", "mse", "psnr", "mse_per_image",
           "psnr_per_image", "bits_y", "bits_z", "bits_total")


def _nchw_to_nhwc(a):
    return np.ascontiguousarray(np.transpose(a, (0, 2, 3, 1)))


def test_rd_loss_matches_jax():
    rng = np.random.default_rng(0)
    out = {"x_hat": rng.uniform(size=(3, 32, 64, 3)).astype(np.float32),
           "logp_y": np.log(rng.uniform(1e-3, 1, size=(3, 2, 4, 8))).astype(np.float32),
           "logp_z": np.log(rng.uniform(1e-3, 1, size=(3, 1, 1, 8))).astype(np.float32)}
    x = rng.uniform(size=(3, 32, 64, 3)).astype(np.float32)
    want = jrd_loss({k: jnp.asarray(v) for k, v in out.items()}, jnp.asarray(x), 0.01)
    got = rd_loss({k: torch.from_numpy(v) for k, v in out.items()}, torch.from_numpy(x), 0.01)
    assert set(got) == set(want) == set(RD_KEYS)
    for k in RD_KEYS:
        assert isinstance(got[k], torch.Tensor), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, err_msg=k)


def test_rd_loss_golden():
    fx = np.load(os.path.join(GOLDEN, "rd_loss_ref.npz"))
    out = {k: torch.from_numpy(_nchw_to_nhwc(fx[k])) for k in ("x_hat", "logp_y", "logp_z")}
    res = rd_loss(out, torch.from_numpy(_nchw_to_nhwc(fx["x"])), 0.01)
    np.testing.assert_allclose(float(res["loss"]), float(fx["loss"]), rtol=1e-5)
    for k in ("bpp_y", "bpp_z", "bpp_total", "mse", "psnr", "bits_total"):
        np.testing.assert_allclose(float(res[k]), float(fx[k]), rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("K", [1, 3])
def test_serving_fn_matches_jax(K):
    x = np.random.default_rng(K).uniform(size=(3, 64, 64, 3)).astype(np.float32)
    jmodel = JModel(latent_channels=8, K=K)
    key = jax.random.PRNGKey(K)
    params = jmodel.init({"params": key, "noise": key}, jnp.asarray(x), training=False)["params"]
    want = jserving.make_serving_fn(jmodel, params)(jnp.asarray(x))
    model = JointAutoregressiveHierarchical(8, K, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    got = serving.make_serving_fn(model)(x)
    assert set(got) == {"x_hat", "bpp_y", "bpp_z", "bpp_total"}
    for k in ("bpp_y", "bpp_z", "bpp_total"):
        assert got[k].shape == (3,), k  # per image, not the batch mean
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(got["x_hat"].numpy(), np.asarray(want["x_hat"]), atol=1e-5)
    assert float(got["x_hat"].min()) >= 0.0 and float(got["x_hat"].max()) <= 1.0


def test_serving_bpp_matches_rd_loss():
    model = JointAutoregressiveHierarchical(8, 2, device="cpu", seed=3)
    x = torch.from_numpy(np.random.default_rng(3).uniform(size=(1, 64, 64, 3)).astype(np.float32))
    got = serving.make_serving_fn(model)(x)
    want = rd_loss(model(x, training=False), x, 0.005)
    np.testing.assert_allclose(float(got["bpp_total"][0]), float(want["bpp_total"]), rtol=1e-6)


def test_port_import_loads_no_jax():
    code = (
        "import sys\n"
        "import neural_image_compression_tpu_torch as p\n"
        "import neural_image_compression_tpu_torch.ops.kernels._build\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', 'neural_image_compression_tpu')\n"
        "             or m.startswith(('jax.', 'jaxlib', 'flax.', 'neural_image_compression_tpu.')))\n"
        "assert not bad, bad\n"
        "assert 'neural_image_compression_tpu_torch.models.joint_ar' in sys.modules\n"
        "print('clean')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        JointAutoregressiveHierarchical(8, 3)
    model = JointAutoregressiveHierarchical(8, 3, device="cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())
