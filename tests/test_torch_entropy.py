"""PyTorch port, entropy models: the Gaussian and mixture likelihoods, the
mixture kernel's plain versions (forward and backward), and the factorized
bottleneck, held against the JAX package (values and gradients) and the
reference's golden fixtures (CPU)."""

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
from test_torch_kernels import _mixture_with_tails, mixture_symbols

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


# --- gradients against jax.vjp --------------------------------------------------

def _vjp_both(jfn, tfn, arrays, cot):
    """Gradients of jfn (JAX) and tfn (port) at the same numpy inputs."""
    _, vjp = jax.vjp(jfn, *map(jnp.asarray, arrays))
    want = [np.asarray(w) for w in vjp(jnp.asarray(cot))]
    leaves = [_t(a).requires_grad_(True) for a in arrays]
    tfn(*leaves).backward(_t(cot))
    return [leaf.grad.numpy() for leaf in leaves], want


def _tail_mask(p):
    """Positions whose likelihood sits above 1e-3. Below it, Phi(u) - Phi(l)
    loses digits to cancellation in float32 and the two packages' erf
    differ by an ulp, so the gradient of log p is noise in both; the floor
    (zero gradient in both) is checked on its own, and the mixture's tails
    against float64 in test_mixture_backward_tails_match_jax_vjp_float64."""
    return np.asarray(p) > 1e-3


def test_mixture_backward_reference_matches_jax_vjp():
    """The kernel's plain backward against jax.vjp of log(mixture_likelihood)
    (the JAX package's training path), the 1e-9 floor included."""
    y, w, mus, sigmas = _mixture_with_tails(96, 3, 16, seed=12)
    g = np.random.default_rng(13).normal(size=y.shape).astype(np.float32)
    shape = (96, 1, 1)  # (B, H, W) of the JAX layout, one position each
    args = (y.reshape(*shape, 16), w.reshape(*shape, 3, 16), mus.reshape(*shape, 3, 16),
            sigmas.reshape(*shape, 3, 16))
    logp, vjp = jax.vjp(lambda *a: jnp.log(jgaussian.mixture_likelihood(*a)),
                        *map(jnp.asarray, args))
    want = [np.asarray(v).reshape(a.shape) for v, a in
            zip(vjp(jnp.asarray(g.reshape(*shape, 16))), (y, w, mus, sigmas))]
    got = gmm_kernel.mixture_log_likelihood_backward_reference(*map(_t, (y, w, mus, sigmas)),
                                                               _t(g))
    keep = _tail_mask(jnp.exp(logp)).reshape(y.shape)
    assert keep.mean() > 0.8
    for name, a, b in zip(("dy", "dw", "dmu", "dsigma"), got, want):
        a = a.numpy()
        if a.ndim == 3:
            a, b = np.swapaxes(a, 1, 2), np.swapaxes(b, 1, 2)  # (N, M, K) to mask by (N, M)
        np.testing.assert_allclose(a[keep], b[keep], rtol=1e-4, atol=1e-6 * np.abs(b).max(),
                                   err_msg=name)
    assert not got[0][0].any() and not want[0][0].any()


class _Float64Jnp:
    """jax.numpy with float32 read as float64: lifts the JAX entropy
    functions' casts so their own formula runs in float64."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def test_mixture_backward_tails_match_jax_vjp_float64(monkeypatch):
    """The tails that the test above masks out (1e-9 < p <= 1e-3), against
    jax.vjp of the JAX package's log(mixture_likelihood) run in float64.
    In float64 (both packages' float32 casts lifted) the port's formula
    meets JAX's at every position, tails included. In float32 the port's
    error there against that float64 truth is no larger than the JAX
    package's own float32 error: the cancellation is the same in both."""
    from neural_image_compression_tpu.ops import math as jmath
    from neural_image_compression_tpu_torch.ops import math as tmath

    n, k, m = 256, 3, 16
    _, w, mus, sigmas = mixture_symbols(n, k, m, seed=16)
    rng = np.random.default_rng(17)
    # each symbol 3 to 6.5 sigmas out from its heaviest component, either side
    spread = rng.uniform(3.0, 6.5, size=(n, m)) * rng.choice([-1.0, 1.0], size=(n, m))
    heaviest = np.argmax(w, axis=1)[:, None]
    y = np.round(np.take_along_axis(mus, heaviest, 1)[:, 0]
                 + spread * np.take_along_axis(sigmas, heaviest, 1)[:, 0]).astype(np.float32)
    g = rng.normal(size=y.shape).astype(np.float32)
    arrays32 = (y, w, mus, sigmas)
    arrays64 = tuple(a.astype(np.float64) for a in arrays32)

    def jax_grads(arrays, cot):
        layout = [arrays[0].reshape(n, 1, 1, m)] + [a.reshape(n, 1, 1, k, m) for a in arrays[1:]]
        logp, vjp = jax.vjp(lambda *a: jnp.log(jgaussian.mixture_likelihood(*a)),
                            *map(jnp.asarray, layout))
        grads = vjp(jnp.asarray(cot.reshape(n, 1, 1, m)))
        return (np.exp(np.asarray(logp).reshape(n, m)),
                [np.asarray(v).reshape(a.shape) for v, a in zip(grads, arrays)])

    p32, jax32 = jax_grads(arrays32, g)
    port32 = gmm_kernel.mixture_log_likelihood_backward_reference(*map(_t, arrays32), _t(g))
    with monkeypatch.context() as mp:
        mp.setattr(jgaussian, "jnp", _Float64Jnp())
        mp.setattr(jmath, "jnp", _Float64Jnp())
        mp.setattr(gmm_kernel, "gaussian_cdf",
                   lambda x: 0.5 * (1.0 + torch.erf(x * tmath.INV_SQRT2)))
        with jax.enable_x64(True):
            p64, truth = jax_grads(arrays64, g.astype(np.float64))
        port64 = gmm_kernel.mixture_log_likelihood_backward_reference(
            *map(_t, arrays64), _t(g.astype(np.float64)))
    assert truth[0].dtype == np.float64 and port64[0].dtype == torch.float64
    tail = (p64 > 1e-9) & (p64 <= 1e-3)
    assert tail.mean() > 0.3
    for name, a64, want, a32, j32 in zip(("dy", "dw", "dmu", "dsigma"), port64, truth,
                                         port32, jax32):
        a64, a32 = a64.numpy(), a32.numpy()
        np.testing.assert_allclose(a64, want, rtol=1e-7, atol=1e-9 * np.abs(want).max(),
                                   err_msg=name)
        if want.ndim == 3:  # (N, K, M) -> (N, M, K) to mask by (N, M)
            a32, j32, want = (np.swapaxes(v, 1, 2) for v in (a32, j32, want))
        err_port, err_jax = np.abs(a32 - want)[tail], np.abs(j32 - want)[tail]
        assert err_port.mean() <= err_jax.mean(), name
        assert err_port.max() <= err_jax.max(), name


def test_gaussian_likelihood_grads_match_jax():
    """The K=1 rate (plain in both packages): log of the clamped Gaussian
    likelihood, gradients to x, mu and sigma."""
    rng = np.random.default_rng(14)
    x = (rng.normal(0, 3, size=(2, 4, 5, 16)) + rng.uniform(-0.5, 0.5, (2, 4, 5, 16))).astype(
        np.float32)
    mu = rng.normal(0, 2, size=x.shape).astype(np.float32)
    sigma = rng.uniform(0.05, 4, size=x.shape).astype(np.float32)
    x[0, 0, 0, :] = mu[0, 0, 0, :] + 500.0  # below the floor
    cot = rng.normal(size=x.shape).astype(np.float32)
    got, want = _vjp_both(lambda *a: jnp.log(jgaussian.gaussian_likelihood(*a)),
                          lambda *a: torch.log(gaussian_likelihood(*a)), (x, mu, sigma), cot)
    keep = _tail_mask(jgaussian.gaussian_likelihood(jnp.asarray(x), jnp.asarray(mu),
                                                    jnp.asarray(sigma)))
    assert keep.mean() > 0.5
    for name, a, b in zip(("dx", "dmu", "dsigma"), got, want):
        np.testing.assert_allclose(a[keep], b[keep], rtol=1e-4, atol=1e-6 * np.abs(b).max(),
                                   err_msg=name)
    assert not got[0][0, 0, 0].any() and not want[0][0, 0, 0].any()


def test_factorized_grads_match_jax():
    """Gradients of the factorized log-likelihood to z and to every
    parameter: the sign-flip's stop-gradient and the floor as in JAX."""
    rng = np.random.default_rng(15)
    c = 16
    x = (rng.normal(0, 2, size=(2, 3, 4, c)) + rng.uniform(-0.5, 0.5, (2, 3, 4, c))).astype(
        np.float32)
    x[0, 0, 0, :] = 400.0  # far past the learned CDF's mass: the floor
    jmod = JFactorized(channels=c)
    params = jmod.init(jax.random.PRNGKey(5), jnp.asarray(x))["params"]
    params = {k: np.asarray(v) + rng.normal(0, 0.3, size=v.shape).astype(np.float32)
              for k, v in params.items()}
    cot = rng.normal(size=x.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda p, a: jnp.log(jmod.apply({"params": p}, a)),
                     jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    want_p, want_x = vjp(jnp.asarray(cot))
    mod = FactorizedEntropyBottleneck(c, device="cpu")
    load_jax_params(mod, params)
    xt = _t(x).requires_grad_(True)
    torch.log(mod(xt)).backward(_t(cot))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), rtol=1e-4,
                               atol=1e-6 * np.abs(np.asarray(want_x)).max())
    for name, p in mod.named_parameters():
        w = np.asarray(want_p[name])
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4, atol=1e-6 * np.abs(w).max(),
                                   err_msg=name)
