"""PyTorch port, evaluation.msssim (ssim, ms_ssim, rgb_to_luma) and
train.loss.msssim_rd_loss, held against the JAX package's on seeded pairs
(CPU), against the reference's golden MS-SSIM values
(tests/golden/msssim_ref.npz), and against jax.grad for the loss's
gradient.

Tolerances: ssim and rgb_to_luma within 1e-6 of JAX. ms_ssim within 5e-6:
at the fifth level (12x16 pixels of a 192x256 pair) SSIM divides
variances of a few 1e-3 that both packages compute as float32
differences of blurred squares, and on these pairs each package sits
0.5-2.9e-6 from a float64 evaluation of the same formula, so 1e-6 is below
what float32 gives either one. The golden values within 1e-5, as
test_golden_parity.py holds the JAX package. A float64 evaluation of the
same formula (written out here) holds the port within 5e-6, also on an
unrelated pair (MS-SSIM about 0.085, contrast terms near 0.01), where
float32 puts both packages 3-4e-6 from it, on either side.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neural_image_compression_tpu.evaluation import msssim as jax_msssim
from neural_image_compression_tpu.train.loss import msssim_rd_loss as jax_msssim_rd_loss
from neural_image_compression_tpu_torch.evaluation import ms_ssim, rgb_to_luma, ssim
from neural_image_compression_tpu_torch.train import msssim_rd_loss

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "msssim_ref.npz")
SSIM_ATOL, MSSSIM_ATOL, GOLDEN_ATOL = 1e-6, 5e-6, 1e-5
W2 = (0.5, 0.5)  # two levels: images down to 21 px a side


def _pair(shape, seed, noise=0.1):
    rng = np.random.default_rng(seed)
    a = rng.uniform(size=shape).astype(np.float32)
    b = np.clip(a + rng.normal(scale=noise, size=shape), 0, 1).astype(np.float32)
    return a, b


PAIRS = {"rgb-192x256": ((2, 192, 256, 3), 0), "gray-171x177": ((1, 171, 177, 1), 1),
         "rgb-176x200-light": ((3, 176, 200, 3), 2)}


@pytest.mark.parametrize("name", list(PAIRS))
@pytest.mark.parametrize("size_average", [True, False])
def test_ssim_and_ms_ssim_match_jax(name, size_average):
    shape, seed = PAIRS[name]
    a, b = _pair(shape, seed, noise=0.02 if "light" in name else 0.1)
    for fn, jfn, atol in ((ssim, jax_msssim.ssim, SSIM_ATOL),
                          (ms_ssim, jax_msssim.ms_ssim, MSSSIM_ATOL)):
        got = fn(torch.from_numpy(a), torch.from_numpy(b), size_average=size_average)
        want = np.asarray(jfn(jnp.asarray(a), jnp.asarray(b), size_average=size_average))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol, err_msg=fn.__name__)


def test_rgb_to_luma_matches_jax():
    a, _ = _pair((2, 9, 11, 3), 3)
    got = rgb_to_luma(torch.from_numpy(a)).numpy()
    want = np.asarray(jax_msssim.rgb_to_luma(jnp.asarray(a)))
    assert got.shape == (2, 9, 11, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=SSIM_ATOL)


def _ms_ssim_float64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The MS-SSIM formula in float64, per image: (B,)."""
    x, y = (torch.from_numpy(v).double().permute(0, 3, 1, 2) for v in (a, b))
    t = torch.arange(11, dtype=torch.float64) - 5.0
    g = torch.exp(-t ** 2 / (2 * 1.5 ** 2))
    g = g / g.sum()
    c = x.shape[1]

    def blur(v):
        v = F.conv2d(v, g.view(1, 1, 11, 1).expand(c, 1, 11, 1), groups=c)
        return F.conv2d(v, g.view(1, 1, 1, 11).expand(c, 1, 1, 11), groups=c)

    weights = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)
    out = 1.0
    for i, w in enumerate(weights):
        mx, my = blur(x), blur(y)
        sxx, syy, sxy = blur(x * x) - mx * mx, blur(y * y) - my * my, blur(x * y) - mx * my
        cs = (2 * sxy + 0.03 ** 2) / (sxx + syy + 0.03 ** 2)
        term = cs if i < len(weights) - 1 else cs * (2 * mx * my + 0.01 ** 2) / (
            mx * mx + my * my + 0.01 ** 2)
        out = out * torch.relu(term.mean(dim=(2, 3))) ** w
        pad = (x.shape[2] % 2, x.shape[3] % 2)
        x, y = (F.avg_pool2d(v, 2, 2, padding=pad) for v in (x, y))
    return out.mean(dim=1).numpy()


@pytest.mark.parametrize("kind", ["noisy", "unrelated"])
def test_ms_ssim_meets_float64(kind):
    a, b = _pair((2, 192, 192, 3), 7)
    if kind == "unrelated":
        b = np.random.default_rng(8).uniform(size=a.shape).astype(np.float32)
    got = ms_ssim(torch.from_numpy(b), torch.from_numpy(a), size_average=False).numpy()
    np.testing.assert_allclose(got, _ms_ssim_float64(b, a), rtol=0, atol=MSSSIM_ATOL)


@pytest.mark.parametrize("pair", ["pair0", "pair1"])
def test_ms_ssim_matches_golden(pair):
    """pair0: RGB 192x256; pair1: gray 171x177 (odd sizes: the padded
    pooling)."""
    fx = np.load(GOLDEN)
    a = torch.from_numpy(fx[pair + "_a"]).permute(0, 2, 3, 1)
    b = torch.from_numpy(fx[pair + "_b"]).permute(0, 2, 3, 1)
    got = float(ms_ssim(a, b, data_range=1.0))
    assert abs(got - float(fx[pair + "_msssim"])) < GOLDEN_ATOL


def test_ms_ssim_identical_is_one_and_custom_weights():
    a, b = _pair((1, 64, 80, 3), 4)
    x = torch.from_numpy(a)
    assert abs(float(ms_ssim(x, x, weights=W2)) - 1.0) < 1e-6
    want = float(jax_msssim.ms_ssim(jnp.asarray(a), jnp.asarray(b), weights=W2))
    assert abs(float(ms_ssim(x, torch.from_numpy(b), weights=W2)) - want) < MSSSIM_ATOL


def test_default_weights_need_161_pixels():
    x = torch.zeros(1, 160, 200, 3)
    with pytest.raises(ValueError, match="161px"):
        ms_ssim(x, x)
    with pytest.raises(ValueError, match="161px"):
        msssim_rd_loss({"x_hat": x, "logp_y": torch.zeros(1, 10, 12, 4),
                        "logp_z": torch.zeros(1, 2, 3, 4)}, x, 4.0)
    ms_ssim(torch.zeros(1, 161, 161, 3), torch.zeros(1, 161, 161, 3))


def _fake_out(shape, seed):
    b, h, w, _ = shape
    rng = np.random.default_rng(seed)
    return {"x_hat": rng.uniform(size=shape).astype(np.float32),
            "logp_y": -rng.uniform(size=(b, h // 16, w // 16, 8)).astype(np.float32),
            "logp_z": -rng.uniform(size=(b, h // 64, w // 64, 8)).astype(np.float32)}


@pytest.mark.parametrize("weights", [None, W2], ids=["5-levels", "2-levels"])
def test_msssim_rd_loss_values_and_gradient_match_jax(weights):
    """Every value of the loss dict, and d loss / d x_hat against jax.grad
    (the blur's backward runs as transposed convolutions in the port)."""
    shape = (2, 192, 192, 3) if weights is None else (2, 64, 64, 3)
    out = _fake_out(shape, 5)
    x = np.random.default_rng(6).uniform(size=shape).astype(np.float32)
    lam = 8.0
    kw = {} if weights is None else {"weights": weights}

    def jloss(x_hat):
        return jax_msssim_rd_loss(dict({k: jnp.asarray(v) for k, v in out.items()},
                                       x_hat=x_hat), jnp.asarray(x), lam, **kw)

    want = jloss(jnp.asarray(out["x_hat"]))
    want_grad = np.asarray(jax.grad(lambda v: jloss(v)["loss"])(jnp.asarray(out["x_hat"])))

    x_hat = torch.from_numpy(out["x_hat"]).requires_grad_(True)
    got = msssim_rd_loss({"x_hat": x_hat, "logp_y": torch.from_numpy(out["logp_y"]),
                          "logp_z": torch.from_numpy(out["logp_z"])}, torch.from_numpy(x),
                         lam, **kw)
    assert set(got) == set(want)
    for k, v in got.items():
        atol = lam * MSSSIM_ATOL if k in ("loss", "msssim", "msssim_per_image") else 0
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(want[k]), rtol=1e-5,
                                   atol=atol, err_msg=k)
    for k in ("mse", "psnr", "mse_per_image", "psnr_per_image", "msssim_per_image"):
        assert not got[k].requires_grad, k
    got["loss"].backward()
    scale = float(np.abs(want_grad).max())
    np.testing.assert_allclose(x_hat.grad.numpy(), want_grad, rtol=1e-3, atol=1e-3 * scale)
