"""PyTorch port, entropy models: the Gaussian and mixture likelihoods, the
mixture kernel's plain version, and the factorized bottleneck, held against
the JAX package and the reference's golden fixtures (CPU)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_image_compression_tpu.entropy import FactorizedEntropyBottleneck as JFactorized
from neural_image_compression_tpu.entropy import gaussian as jgaussian
from neural_image_compression_tpu.ops.pallas.gmm_kernel import (
    fused_mixture_log_likelihood, mixture_log_likelihood_reference as jmixture_reference,
)
from neural_image_compression_tpu_torch.entropy import (
    FactorizedEntropyBottleneck, gaussian_likelihood, mixture_likelihood,
)
from neural_image_compression_tpu_torch.ops.kernels import gmm_kernel
from neural_image_compression_tpu_torch.utils.weights import load_jax_params
from test_torch_kernels import mixture_symbols

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _nchw_to_nhwc(a):
    return np.transpose(a, (0, 2, 3, 1))


def _ref_mixture_layout(a):
    """reference (B, K, M, H, W) -> (B, H, W, K, M)."""
    return np.transpose(a, (0, 3, 4, 1, 2))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_gaussian_likelihood_matches_jax():
    rng = np.random.default_rng(0)
    x = np.round(rng.normal(0, 3, size=(2, 4, 5, 16))).astype(np.float32)
    mu = rng.normal(0, 2, size=x.shape).astype(np.float32)
    sigma = (rng.uniform(0.05, 4, size=x.shape)).astype(np.float32)
    want = np.asarray(jgaussian.gaussian_likelihood(jnp.asarray(x), jnp.asarray(mu),
                                                    jnp.asarray(sigma)))
    got = gaussian_likelihood(_t(x), _t(mu), _t(sigma)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=3e-7)


def test_mixture_likelihood_matches_jax():
    y, w, mus, sigmas = mixture_symbols(80, 3, 16, seed=1)
    shape = (2, 5, 8)
    args = (y.reshape(*shape, 16), w.reshape(*shape, 3, 16),
            mus.reshape(*shape, 3, 16), sigmas.reshape(*shape, 3, 16))
    want = np.asarray(jgaussian.mixture_likelihood(*map(jnp.asarray, args)))
    got = mixture_likelihood(*map(_t, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=3e-7)


def test_gaussian_golden():
    fx = np.load(os.path.join(GOLDEN, "gaussian_ref.npz"))
    p = gaussian_likelihood(_t(_nchw_to_nhwc(fx["x"])), _t(_nchw_to_nhwc(fx["mu"])),
                            _t(_nchw_to_nhwc(fx["sigma"])))
    # atol 3e-7: torch and jax f32 erf differ by ~1 ulp in the deep tail
    np.testing.assert_allclose(p.numpy(), _nchw_to_nhwc(fx["p"]), rtol=1e-5, atol=3e-7)
    pm = mixture_likelihood(_t(_nchw_to_nhwc(fx["x"])), _t(_ref_mixture_layout(fx["w"])),
                            _t(_ref_mixture_layout(fx["mus"])),
                            _t(_ref_mixture_layout(fx["sigmas"])))
    np.testing.assert_allclose(pm.numpy(), _nchw_to_nhwc(fx["pm"]), rtol=1e-5, atol=1e-7)


def test_mixture_reference_matches_pallas_interpret():
    """Bulk symbols: the Pallas kernel's rational erf drifts only below
    p = 1e-6, so agreement is held there and on the total rate."""
    y, w, mus, sigmas = mixture_symbols(300, 3, 128, seed=2)
    want = np.asarray(fused_mixture_log_likelihood(
        *map(jnp.asarray, (y, w, mus, sigmas)), block_n=128, interpret=True))
    got = gmm_kernel.gmm_logp(*map(_t, (y, w, mus, sigmas))).numpy()
    bulk = want > np.log(1e-6)
    assert bulk.mean() > 0.99
    np.testing.assert_allclose(got[bulk], want[bulk], rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(got.sum(), want.sum(), rtol=1e-4)


def test_mixture_reference_matches_exact_jnp_path():
    """Against the JAX package's exact-erf reference: every symbol, tails too."""
    y, w, mus, sigmas = mixture_symbols(300, 3, 128, seed=3)
    want = np.asarray(jmixture_reference(*map(jnp.asarray, (y, w, mus, sigmas))))
    got = gmm_kernel.mixture_log_likelihood_reference(*map(_t, (y, w, mus, sigmas))).numpy()
    p = np.exp(want)
    np.testing.assert_allclose(np.exp(got), p, rtol=1e-5, atol=3e-7)
    big = p > 1e-3
    np.testing.assert_allclose(got[big], want[big], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.sum(dtype=np.float64), want.sum(dtype=np.float64),
                               rtol=1e-6)


def test_mixture_floor():
    y = torch.full((8, 128), 1000.0)
    ones = torch.ones(8, 1, 128)
    got = gmm_kernel.gmm_logp(y, ones, torch.zeros(8, 1, 128), ones)
    np.testing.assert_allclose(got.numpy(), np.log(1e-9), rtol=1e-5)


def test_factorized_matches_jax():
    rng = np.random.default_rng(4)
    c = 16
    x = np.round(rng.normal(0, 2, size=(2, 3, 4, c))).astype(np.float32)
    jmod = JFactorized(channels=c)
    params = jmod.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"]
    # move off the constant init so every parameter matters
    params = {k: np.asarray(v) + rng.normal(0, 0.3, size=v.shape).astype(np.float32)
              for k, v in params.items()}
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    mod = FactorizedEntropyBottleneck(c, device="cpu")
    load_jax_params(mod, params)
    got = mod(_t(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    xs = np.linspace(-6, 6, 25).astype(np.float32)
    for method in ("grid_cdf", "grid_pmf"):
        want_g = np.asarray(jmod.apply({"params": params}, jnp.asarray(xs), method=method))
        got_g = getattr(mod, method)(_t(xs)).detach().numpy()
        np.testing.assert_allclose(got_g, want_g, rtol=1e-4, atol=1e-7, err_msg=method)


@pytest.fixture(scope="module")
def factorized_golden():
    fx = np.load(os.path.join(GOLDEN, "factorized_ref.npz"))
    mod = FactorizedEntropyBottleneck(fx["x"].shape[1], device="cpu")
    load_jax_params(mod, {k: fx[k] for k in fx.files
                          if k.startswith(("matrix_", "bias_", "factor_"))})
    return fx, mod


def test_factorized_golden_likelihood(factorized_golden):
    fx, mod = factorized_golden
    lik = mod(_t(_nchw_to_nhwc(fx["x"]))).detach().numpy()
    np.testing.assert_allclose(lik, _nchw_to_nhwc(fx["likelihood"]), rtol=1e-5, atol=1e-7)


def test_factorized_golden_cdf_pmf(factorized_golden):
    fx, mod = factorized_golden
    xs = _t(fx["xs"])
    np.testing.assert_allclose(mod.grid_cdf(xs).detach().numpy(), fx["channel_cdf"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mod.grid_pmf(xs).detach().numpy(),
                               np.maximum(fx["channel_pmf"], 1e-12), rtol=1e-4, atol=1e-7)
