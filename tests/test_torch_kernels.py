"""PyTorch port, kernel wrappers: input checks, plain versions (forward and
backward, the backward held against autograd of the plain forward) and the
autograd plumbing on the CPU and, on a CUDA card only, each hand-written
kernel against its plain version, and the scalable model's kernel launches,
its LatentSpaceTransform against the CPU and its codec's round trip. This
file imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from neural_image_compression_tpu_torch.ops.kernels import gdn_kernel, gmm_kernel
from neural_image_compression_tpu_torch.ops.kernels import launch_counts

torch.set_num_threads(1)


def _softmax(a, axis):
    e = np.exp(a - a.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def mixture_symbols(n, k, m, seed):
    """Mixture params and symbols drawn FROM the mixture, as a trained model
    sees them (the regime of tests/test_pallas.py)."""
    rng = np.random.default_rng(seed)
    w = _softmax(rng.normal(size=(n, k, m)), axis=1).astype(np.float32)
    mus = (2 * rng.normal(size=(n, k, m))).astype(np.float32)
    sigmas = (np.log1p(np.exp(rng.normal(size=(n, k, m)))) + 1e-6).astype(np.float32)
    u = rng.uniform(size=(n, 1, m))
    comp = np.minimum((np.cumsum(w, axis=1) < u).sum(axis=1), k - 1)  # (n, m)
    mu_sel = np.take_along_axis(mus, comp[:, None, :], axis=1)[:, 0, :]
    sig_sel = np.take_along_axis(sigmas, comp[:, None, :], axis=1)[:, 0, :]
    y = np.round(mu_sel + sig_sel * rng.normal(size=(n, m))).astype(np.float32)
    return y, w, mus, sigmas


def test_gdn_wrapper_checks_its_inputs():
    x = torch.ones(4, 8)
    g, b = torch.eye(8), torch.ones(8)
    with pytest.raises(ValueError, match="rows"):
        gdn_kernel.gdn(torch.ones(2, 4, 8), g, b)
    with pytest.raises(ValueError, match="gamma must be"):
        gdn_kernel.gdn(x, torch.eye(4), b)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gdn_kernel.gdn(x.double(), g, b)
    with pytest.raises(ValueError, match="contiguous"):
        gdn_kernel.gdn(torch.ones(8, 4).t(), g, b)
    with pytest.raises(ValueError, match="at most 256"):
        gdn_kernel.gdn(torch.ones(2, 257), torch.eye(257), torch.ones(257))


def test_gdn_reference_bf16_keeps_dtype_and_f32_math():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(33, 16)).astype(np.float32)).to(torch.bfloat16)
    g = torch.from_numpy(np.abs(rng.normal(0, 0.1, (16, 16))).astype(np.float32))
    b = torch.ones(16)
    got = gdn_kernel.gdn(x, g, b)
    assert got.dtype == torch.bfloat16
    want = gdn_kernel.gdn_reference(x.float(), g, b).to(torch.bfloat16)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# --- the GDN kernel's split-precision design, emulated in numpy --------------
# The card kernel computes the channel mix on the tensor cores with each
# product split in three (csrc/gdn_kernel.cu): 3xTF32 for float32 x and
# 3xbf16 for bfloat16 x, float32 accumulation. These tests pin the numeric
# argument on the CPU; the sums are taken in float64 (exact accumulation).

def _bf16(a):
    """Round float32 values to bfloat16 (nearest, ties to even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(
        torch.bfloat16).float().numpy()


def _tf32_rna(a):
    """Round float32 values to TF32 (10 stored mantissa bits), nearest with
    ties away from zero: cvt.rna.tf32.f32."""
    bits = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _gdn_operands(rows, c, seed):
    """x, gamma and beta drawn as chip_smoke.py draws them."""
    rng = np.random.default_rng(seed)
    gamma = np.abs(rng.normal(0.0, 0.02, (c, c))).astype(np.float32)
    gamma[np.arange(c), np.arange(c)] += 0.1
    beta = rng.uniform(0.5, 1.5, c).astype(np.float32)
    x = rng.standard_normal((rows, c), dtype=np.float32)
    return x, gamma, beta


def _rel_err_of_norm(s_hi, s_lo, g_hi, g_lo, x, gamma, beta):
    split = (s_lo.astype(np.float64) @ g_hi + s_hi.astype(np.float64) @ g_lo
             + s_hi.astype(np.float64) @ g_hi + beta)
    x64 = x.astype(np.float64)
    exact = (x64 * x64) @ gamma.astype(np.float64) + beta
    return np.abs(split / exact - 1.0).max()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_square_splits_exactly_into_two_bf16(seed):
    rng = np.random.default_rng(seed)
    mag = 10.0 ** rng.uniform(-4.0, 4.0, 100_000)
    x = _bf16(np.where(rng.uniform(size=mag.size) < 0.5, -mag, mag).astype(np.float32))
    s = x * x  # at most 16 significant bits: exact in float32
    assert np.array_equal(s.astype(np.float64), x.astype(np.float64) ** 2)
    s_hi = _bf16(s)
    s_lo = _bf16(s - s_hi)
    assert np.array_equal(s - s_hi, s_lo)  # the remainder is a bf16 value
    assert np.array_equal(s_hi.astype(np.float64) + s_lo, s.astype(np.float64))


@pytest.mark.parametrize("c", [16, 128, 192])
def test_three_tf32_products_keep_float32_grade_norm(c):
    x, gamma, beta = _gdn_operands(8192, c, seed=c)
    s = x * x
    s_hi = _tf32_rna(s)
    s_lo = _tf32_rna(s - s_hi)
    g_hi = _tf32_rna(gamma)
    g_lo = _tf32_rna(gamma - g_hi)
    err = _rel_err_of_norm(s_hi, s_lo, g_hi, g_lo, x, gamma, beta)
    assert err <= 1e-6, err
    # one TF32 product alone is three orders of magnitude worse
    single = _rel_err_of_norm(s_hi, np.zeros_like(s), g_hi, np.zeros_like(gamma),
                              x, gamma, beta)
    assert single > 1e-4, single


def _split(a, rnd):
    hi = rnd(a)
    return hi, rnd(a - hi)


def _split_product(a, b, rnd):
    """a @ b as the kernels take it: each operand split into hi and lo in
    the tensor cores' type, lo @ lo dropped, the rest summed exactly."""
    a_hi, a_lo = _split(a, rnd)
    b_hi, b_lo = _split(b, rnd)
    f = np.float64
    return a_lo.astype(f) @ b_hi + a_hi.astype(f) @ b_lo + a_hi.astype(f) @ b_hi


def _backward_terms(n, x, g, inverse):
    """t and d1 from the norm, in float32 as the norm launch's epilogue."""
    n = n.astype(np.float32)
    if inverse:
        s = np.sqrt(n)
        return g * x / s, g * s
    r = np.float32(1.0) / np.sqrt(n)
    return g * x * (r * r * r), g * r


def _backward_float64(x, gamma, beta, g, inverse):
    """dx, dgamma, dbeta in float64 from the same float32 inputs."""
    x, g, gamma = x.astype(np.float64), g.astype(np.float64), gamma.astype(np.float64)
    n = (x * x) @ gamma + beta
    s = np.sqrt(n)
    t = g * x / s if inverse else g * x / (n * s)
    sign, half = (1.0, 0.5) if inverse else (-1.0, -0.5)
    dx = (g * s if inverse else g / s) + sign * x * (t @ gamma.T)
    return dx, half * ((x * x).T @ t), half * t.sum(axis=0)


def _within_backward_tolerance(got, want, shrink=1.0):
    """chip_smoke.py's check_gdn_backward tolerance for float32 outputs, 1e-4
    relative plus 1e-5 of the largest value, divided by ``shrink``."""
    limit = (1e-4 * np.abs(want) + 1e-5 * np.abs(want).max()) / shrink
    return bool((np.abs(got - want) <= limit).all())


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("c", [16, 128, 192])
def test_mix_launch_three_tf32_products_keep_float32_grade_dx(c, inverse):
    # csrc/gdn_bwd_kernel.cu launch 2: u = t . gamma^T as 3xTF32 (t and gamma
    # each split hi/lo), after launch 1's 3xTF32 norm and float32 t, d1
    x, gamma, beta = _gdn_operands(8192, c, seed=200 + c)
    g = np.random.default_rng(c).standard_normal(x.shape, dtype=np.float32)
    n = _split_product(x * x, gamma, _tf32_rna) + beta
    t, d1 = _backward_terms(n, x, g, inverse)
    u = _split_product(t, gamma.T, _tf32_rna)
    scale = np.abs(t).astype(np.float64) @ np.abs(gamma.T)
    assert (np.abs(u - t.astype(np.float64) @ gamma.T) / scale).max() <= 1e-6
    sign = np.float32(1.0 if inverse else -1.0)
    dx = d1 + sign * x * u.astype(np.float32)
    want = _backward_float64(x, gamma, beta, g, inverse)[0]
    assert _within_backward_tolerance(dx, want, shrink=10.0)
    # one TF32 product for u (t and gamma rounded to TF32 once) fails the
    # tolerance itself
    single = (_tf32_rna(t).astype(np.float64) @ _tf32_rna(gamma.T)).astype(np.float32)
    assert not _within_backward_tolerance(d1 + sign * x * single, want)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("c", [16, 128])
def test_norm_launch_three_bf16_products_keep_dgamma_dbeta(c, inverse):
    # csrc/gdn_bwd_kernel.cu launch 1 for bfloat16 rows: the norm as 3xbf16
    # (x^2 split exactly, gamma hi/lo), t in float32, then dgamma and dbeta
    # summed over 65,536 rows (float64 here; launches 3 and 4 in float32)
    x, gamma, beta = _gdn_operands(65_536, c, seed=300 + c)
    x = _bf16(x)
    g = _bf16(np.random.default_rng(c).standard_normal(x.shape, dtype=np.float32))
    n = _split_product(x * x, gamma, _bf16) + beta
    t = _backward_terms(n, x, g, inverse)[0].astype(np.float64)
    half = 0.5 if inverse else -0.5
    dgamma = half * ((x * x).astype(np.float64).T @ t)
    dbeta = half * t.sum(axis=0)
    _, want_dgamma, want_dbeta = _backward_float64(x, gamma, beta, g, inverse)
    assert _within_backward_tolerance(dgamma, want_dgamma)
    assert _within_backward_tolerance(dbeta, want_dbeta)


@pytest.mark.parametrize("c", [16, 128, 192])
def test_three_bf16_products_keep_norm_within_3e_5(c):
    x, gamma, beta = _gdn_operands(8192, c, seed=100 + c)
    x = _bf16(x)
    s = x * x
    s_hi = _bf16(s)
    s_lo = _bf16(s - s_hi)
    g_hi = _bf16(gamma)
    g_lo = _bf16(gamma - g_hi)
    err = _rel_err_of_norm(s_hi, s_lo, g_hi, g_lo, x, gamma, beta)
    assert err <= 3e-5, err


# --- the backward's plain versions and the autograd plumbing -----------------

def _gdn_case(n, c, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32))
    gamma = torch.from_numpy(np.abs(rng.normal(0, 0.05, (c, c))).astype(np.float32))
    beta = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32))
    return x, gamma, beta, g


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("c", [6, 16, 128])
def test_gdn_backward_reference_matches_autograd(c, inverse):
    x, gamma, beta, g = _gdn_case(300, c, seed=c)
    leaves = [t.clone().requires_grad_(True) for t in (x, gamma, beta)]
    gdn_kernel.gdn_reference(*leaves, inverse).backward(g)
    got = gdn_kernel.gdn_backward_reference(x, gamma, beta, g, inverse)
    for name, a, leaf in zip(("dx", "dgamma", "dbeta"), got, leaves):
        # float32 both ways, the products' sums in other orders
        torch.testing.assert_close(a, leaf.grad, rtol=1e-5, atol=1e-5 * float(leaf.grad.abs().max()),
                                   msg=name)


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_autograd_runs_the_plain_backward_on_cpu(inverse):
    x, gamma, beta, g = _gdn_case(70, 16, seed=9)
    leaves = [t.clone().requires_grad_(True) for t in (x, gamma, beta)]
    counts = (gdn_kernel.gdn.launches, gdn_kernel.gdn_backward.launches)
    out = gdn_kernel.gdn(*leaves, inverse)
    torch.testing.assert_close(out, gdn_kernel.gdn_reference(x, gamma, beta, inverse),
                               rtol=0, atol=0)
    # g in column-major layout: the wrapper copies it into rows
    g_strided = g.t().contiguous().t()
    out.backward(g_strided)
    want = gdn_kernel.gdn_backward_reference(x, gamma, beta, g, inverse)
    for a, leaf in zip(want, leaves):
        torch.testing.assert_close(leaf.grad, a, rtol=0, atol=0)
    assert (gdn_kernel.gdn.launches, gdn_kernel.gdn_backward.launches) == counts
    with torch.no_grad():
        assert gdn_kernel.gdn(*leaves, inverse).grad_fn is None


@pytest.mark.parametrize("inverse", [False, True])
def test_gdn_backward_skips_param_grads_for_frozen_weights(inverse, monkeypatch):
    x, gamma, beta, g = _gdn_case(90, 16, seed=12)
    full = gdn_kernel.gdn_backward(x, gamma, beta, g, inverse)
    dx, dgamma, dbeta = gdn_kernel.gdn_backward(x, gamma, beta, g, inverse, param_grads=False)
    assert dgamma is None and dbeta is None
    torch.testing.assert_close(dx, full[0], rtol=0, atol=0)
    # autograd asks for dx alone where neither gamma nor beta needs a gradient
    asked = []
    real = gdn_kernel.gdn_backward
    monkeypatch.setattr(gdn_kernel, "gdn_backward",
                        lambda *a: asked.append(a[-1]) or real(*a))
    for needs in ((False, False), (True, False), (True, True)):
        xl = x.clone().requires_grad_(True)
        gl, bl = gamma.clone().requires_grad_(needs[0]), beta.clone().requires_grad_(needs[1])
        gdn_kernel.gdn(xl, gl, bl, inverse).backward(g)
        torch.testing.assert_close(xl.grad, full[0], rtol=0, atol=0)
        if needs[0]:
            torch.testing.assert_close(gl.grad, full[1], rtol=0, atol=0)
    assert asked == [False, True, True]


def test_gdn_backward_bf16_keeps_dtypes():
    x, gamma, beta, g = _gdn_case(50, 16, seed=11)
    dx, dgamma, dbeta = gdn_kernel.gdn_backward(x.bfloat16(), gamma, beta, g.bfloat16())
    assert dx.dtype == torch.bfloat16
    assert dgamma.dtype == dbeta.dtype == torch.float32
    want = gdn_kernel.gdn_backward_reference(x.bfloat16().float(), gamma, beta,
                                             g.bfloat16().float())
    torch.testing.assert_close(dx, want[0].bfloat16(), rtol=0, atol=0)
    torch.testing.assert_close(dgamma, want[1], rtol=0, atol=0)


def test_gdn_backward_checks_g():
    x, gamma, beta, g = _gdn_case(8, 4, seed=0)
    with pytest.raises(ValueError, match="g must match"):
        gdn_kernel.gdn_backward(x, gamma, beta, g[:4])
    with pytest.raises(ValueError, match="g must match"):
        gdn_kernel.gdn_backward(x, gamma, beta, g.bfloat16())


@pytest.mark.parametrize("n", [1, 255, 256, 16_384, 65_536, 100_003, 262_144, 4_718_592])
def test_gdn_backward_chunking_covers_the_rows(n):
    rows, chunks = gdn_kernel._chunking(n)
    assert rows % 32 == 0 and rows >= 256
    assert 1 <= chunks <= 256
    assert (chunks - 1) * rows < n <= chunks * rows


@pytest.mark.parametrize("esz", [4, 2])
@pytest.mark.parametrize("c", [1, 3, 4, 8, 10, 16, 100, 128, 192, 250, 256])
def test_gdn_padded_width_suits_tma(c, esz):
    # rows go to the kernels as they are only where TMA can describe them
    aligned = gdn_kernel._padded_width(c, esz, (0, 512))
    assert (aligned is None) == ((c * esz) % 16 == 0)
    for cp in (aligned, gdn_kernel._padded_width(c, esz, (0, 4))):
        if cp is not None:
            assert cp >= c and cp % 16 == 0 and cp <= gdn_kernel.MAX_CHANNELS
    assert gdn_kernel._padded_width(c, esz, (0, 4)) is not None


def _mixture_with_tails(n, k, m, seed):
    """Mixture symbols plus positions far in a tail (p just above the 1e-9
    floor) and beyond it (p below the floor: zero gradient)."""
    y, w, mus, sigmas = mixture_symbols(n, k, m, seed)
    y = y.copy()
    y[0, :] = 1000.0                                  # below the floor everywhere
    y[1, :] = np.round(mus[1, 0] + 5.8 * sigmas[1, 0])  # deep in one component's tail
    return y, w, mus, sigmas


@pytest.mark.parametrize("k", [1, 3])
def test_mixture_backward_reference_matches_autograd(k):
    arrays = _mixture_with_tails(64, k, 16, seed=k)
    inputs = [torch.from_numpy(a) for a in arrays]
    g = torch.from_numpy(np.random.default_rng(7).normal(size=arrays[0].shape).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    gmm_kernel.mixture_log_likelihood_reference(*leaves).backward(g)
    got = gmm_kernel.mixture_log_likelihood_backward_reference(*inputs, g)
    for name, a, leaf in zip(("dy", "dw", "dmu", "dsigma"), got, leaves):
        torch.testing.assert_close(a, leaf.grad, rtol=1e-4, atol=1e-6 * float(leaf.grad.abs().max()),
                                   msg=name)
    assert torch.count_nonzero(got[0][0]) == 0  # below the floor: no gradient
    assert torch.count_nonzero(got[0][1]) > 0


def test_gmm_autograd_runs_the_plain_backward_on_cpu():
    inputs = [torch.from_numpy(a) for a in mixture_symbols(40, 3, 8, seed=2)]
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    counts = (gmm_kernel.gmm_logp.launches, gmm_kernel.gmm_logp_backward.launches)
    logp = gmm_kernel.gmm_logp(*leaves)
    # a loss like rd_loss's: the sum's gradient reaches the kernel as a broadcast
    (-logp.sum() / 3.0).backward()
    want = gmm_kernel.mixture_log_likelihood_backward_reference(
        *inputs, torch.full_like(inputs[0], -1.0 / 3.0))
    for a, leaf in zip(want, leaves):
        torch.testing.assert_close(leaf.grad, a, rtol=0, atol=0)
    assert (gmm_kernel.gmm_logp.launches, gmm_kernel.gmm_logp_backward.launches) == counts


def test_gmm_backward_checks_g():
    inputs = [torch.from_numpy(a) for a in mixture_symbols(4, 2, 8, seed=0)]
    with pytest.raises(ValueError, match="g must be"):
        gmm_kernel.gmm_logp_backward(*inputs, torch.zeros(4, 7))
    with pytest.raises(ValueError, match="g must be"):
        gmm_kernel.gmm_logp_backward(*inputs, torch.zeros(4, 8, dtype=torch.float64))


def test_gmm_wrapper_checks_its_inputs():
    y = torch.zeros(4, 8)
    w = torch.ones(4, 3, 8) / 3
    with pytest.raises(ValueError, match="K must be"):
        gmm_kernel.gmm_logp(y, torch.ones(4, 9, 8), torch.ones(4, 9, 8), torch.ones(4, 9, 8))
    with pytest.raises(ValueError, match="mus must be"):
        gmm_kernel.gmm_logp(y, w, torch.zeros(4, 2, 8), torch.ones(4, 3, 8))
    with pytest.raises(TypeError, match="float32"):
        gmm_kernel.gmm_logp(y.double(), w, w, w)


# --- on the card only: each kernel against its plain version ----------------

@pytest.fixture
def cuda_device(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    # the plain versions' products in full float32, as the kernels compute
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("inverse", [False, True])
# ragged last row tiles; channel counts that fill, and that leave ragged,
# the kernel's 64-channel padded widths; 100 (bf16) and 10 take the wrapper's
# padded route; 192 and 256 the widths where gamma is cut into slices
@pytest.mark.parametrize("n,c", [(1000, 128), (77, 100), (300, 16), (513, 256),
                                 (100003, 128), (4096, 192), (64, 10)])
def test_gdn_kernel_matches_plain_on_card(cuda_device, dtype, inverse, n, c):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32)).to(cuda_device, dtype)
    gamma = torch.from_numpy(np.abs(rng.normal(0, 0.05, (c, c))).astype(np.float32)).to(cuda_device)
    beta = torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)).to(cuda_device)
    before = gdn_kernel.gdn.launches
    got = gdn_kernel.gdn(x, gamma, beta, inverse)
    torch.cuda.synchronize()
    assert gdn_kernel.gdn.launches == before + 1
    want = gdn_kernel.gdn_reference(x, gamma, beta, inverse)
    assert got.dtype == dtype
    tol = 1e-5 if dtype == torch.float32 else 8e-3  # bf16: one rounding step of the output
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,m", [(1000, 3, 128), (37, 1, 100), (50, 8, 16)])
def test_gmm_kernel_matches_plain_on_card(cuda_device, n, k, m):
    args = [torch.from_numpy(a).to(cuda_device) for a in mixture_symbols(n, k, m, seed=5)]
    before = gmm_kernel.gmm_logp.launches
    got = gmm_kernel.gmm_logp(*args)
    torch.cuda.synchronize()
    assert gmm_kernel.gmm_logp.launches == before + 1
    want = gmm_kernel.mixture_log_likelihood_reference(*args)
    bulk = want > np.log(1e-6)
    torch.testing.assert_close(got[bulk], want[bulk], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.double().sum().item(), want.double().sum().item(), rtol=1e-6)


def _assert_grad_close(got, want, name, dtype=torch.float32):
    """f32: within 1e-4 relative plus 1e-5 of the largest value (the kernel
    sums in other orders than cuBLAS, dgamma over up to 262,144 rows); a
    bf16 dx: within one bf16 step (at most 2^-7 relative) of the plain
    version, where their float32 values round to neighbouring steps."""
    scale = float(want.float().abs().max())
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * scale, msg=name)
    else:
        diff = (got.float() - want.float()).abs()
        limit = 2.0 ** -7 * want.float().abs() + 1e-5 * scale
        assert bool((diff <= limit).all()), f"{name}: max diff {float(diff.max()):.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("inverse", [False, True])
# the train step's three sites (batch 16 at 256x256), ragged rows (also at
# the widths where gamma is cut into slices: 192, 256), widths that leave
# ragged 64-channel groups, and widths the wrapper pads (10; 100 in bf16)
@pytest.mark.parametrize("n,c", [(262_144, 128), (65_536, 128), (16_384, 128),
                                 (100_003, 128), (77, 100), (300, 16), (513, 256),
                                 (4096, 192), (64, 10), (1001, 192), (70, 256),
                                 (1001, 10)])
def test_gdn_backward_kernel_matches_plain_on_card(cuda_device, dtype, inverse, n, c):
    x, gamma, beta, g = (t.to(cuda_device) for t in _gdn_case(n, c, seed=1))
    x, g = x.to(dtype), g.to(dtype)
    before = gdn_kernel.gdn_backward.launches
    got = gdn_kernel.gdn_backward(x, gamma, beta, g, inverse)
    torch.cuda.synchronize()
    assert gdn_kernel.gdn_backward.launches == before + 1
    want = gdn_kernel.gdn_backward_reference(x, gamma, beta, g, inverse)
    assert got[0].dtype == dtype and got[1].dtype == got[2].dtype == torch.float32
    _assert_grad_close(got[0], want[0], "dx", dtype)
    _assert_grad_close(got[1], want[1], "dgamma")
    _assert_grad_close(got[2], want[2], "dbeta")
    # no atomics: a second run gives the same bits
    again = gdn_kernel.gdn_backward(x, gamma, beta, g, inverse)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c", [(98_304, 128), (1001, 10)])
def test_gdn_backward_dx_only_on_card(cuda_device, dtype, n, c):
    # without the dgamma/dbeta stage: the same dx bits, one launch, no stage
    x, gamma, beta, g = (t.to(cuda_device) for t in _gdn_case(n, c, seed=4))
    x, g = x.to(dtype), g.to(dtype)
    full = gdn_kernel.gdn_backward(x, gamma, beta, g, True)
    before = (gdn_kernel.gdn_backward.launches, gdn_kernel.gdn_backward.param_launches)
    dx, dgamma, dbeta = gdn_kernel.gdn_backward(x, gamma, beta, g, True, param_grads=False)
    torch.cuda.synchronize()
    assert (gdn_kernel.gdn_backward.launches, gdn_kernel.gdn_backward.param_launches) == (
        before[0] + 1, before[1])
    assert dgamma is None and dbeta is None
    assert torch.equal(dx, full[0])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gdn_kernels_take_rows_at_an_unaligned_address_on_card(cuda_device, dtype):
    # rows starting 4 bytes past an aligned address: TMA cannot take them, so
    # both wrappers run their kernels on aligned, padded copies
    x, gamma, beta, g = (t.to(cuda_device) for t in _gdn_case(1000, 128, seed=3))
    x, g = x.to(dtype), g.to(dtype)
    shift = 4 // x.element_size()
    xs = torch.empty(x.numel() + shift, dtype=dtype, device=cuda_device)[shift:].view_as(x)
    gs = torch.empty(g.numel() + shift, dtype=dtype, device=cuda_device)[shift:].view_as(g)
    xs.copy_(x)
    gs.copy_(g)
    assert xs.data_ptr() % 16 and gs.data_ptr() % 16
    got = gdn_kernel.gdn(xs, gamma, beta)
    torch.testing.assert_close(got.float(), gdn_kernel.gdn_reference(x, gamma, beta).float(),
                               rtol=1e-5 if dtype == torch.float32 else 8e-3,
                               atol=1e-5 if dtype == torch.float32 else 8e-3)
    got = gdn_kernel.gdn_backward(xs, gamma, beta, gs)
    want = gdn_kernel.gdn_backward_reference(x, gamma, beta, g)
    for name, a, b in zip(("dx", "dgamma", "dbeta"), got, want):
        _assert_grad_close(a, b, name, dtype if name == "dx" else torch.float32)


@pytest.mark.cuda
def test_gdn_autograd_launches_both_kernels_on_card(cuda_device):
    x, gamma, beta, g = (t.to(cuda_device) for t in _gdn_case(4096, 128, seed=2))
    leaves = [t.clone().requires_grad_(True) for t in (x, gamma, beta)]
    counts = (gdn_kernel.gdn.launches, gdn_kernel.gdn_backward.launches)
    # g in another layout than the rows: the wrapper copies it
    gdn_kernel.gdn(*leaves).backward(g.t().contiguous().t())
    torch.cuda.synchronize()
    assert (gdn_kernel.gdn.launches, gdn_kernel.gdn_backward.launches) == (counts[0] + 1,
                                                                           counts[1] + 1)
    want = gdn_kernel.gdn_backward_reference(x, gamma, beta, g)
    for name, a, leaf in zip(("dx", "dgamma", "dbeta"), want, leaves):
        _assert_grad_close(leaf.grad, a, name)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,m", [(4096, 3, 128), (37, 1, 100), (50, 8, 16)])
def test_gmm_backward_kernel_matches_plain_on_card(cuda_device, n, k, m):
    arrays = _mixture_with_tails(n, k, m, seed=6)
    inputs = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    g = torch.from_numpy(np.random.default_rng(8).normal(size=(n, m)).astype(np.float32)).to(
        cuda_device)
    before = gmm_kernel.gmm_logp_backward.launches
    got = gmm_kernel.gmm_logp_backward(*inputs, g)
    torch.cuda.synchronize()
    assert gmm_kernel.gmm_logp_backward.launches == before + 1
    want = gmm_kernel.mixture_log_likelihood_backward_reference(*inputs, g)
    for name, a, b in zip(("dy", "dw", "dmu", "dsigma"), got, want):
        # both use CUDA's erff and expf; the K-sum and divisions may round apart
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6 * float(b.abs().max()), msg=name)
    assert torch.count_nonzero(got[0][0]) == 0


# --- on the card only: the scalable model's paths through the kernels -------------

def _scalable(device, K, seed=3):
    """ScalableImageCoding(16, 10, K), a gain on the analysis bottleneck so
    that y spreads over several integers."""
    from neural_image_compression_tpu_torch.models import ScalableImageCoding

    model = ScalableImageCoding(16, 10, K, device=device, seed=seed)
    with torch.no_grad():
        model.encoder.Conv2d_3.weight.mul_(12.0)
        model.encoder.Conv2d_3.bias.mul_(12.0)
    return model


def _launched(fn):
    before = launch_counts()
    fn()
    torch.cuda.synchronize()
    after = launch_counts()
    return {k: after[k] - before[k] for k in after}


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 3])
def test_scalable_model_launches_on_card(cuda_device, K):
    """The eval forward launches the GDN kernel 9 times (3 GDN, 3 IGDN and
    the LatentSpaceTransform's 3 IGDN) and, at K > 1, the mixture kernel
    once a layer; a step with the vision term runs every GDN backward with
    its dgamma/dbeta stage, and each layer's mixture backward."""
    from neural_image_compression_tpu_torch.models import build_yolo_backbone, distillation_targets
    from neural_image_compression_tpu_torch.train import vision_rd_loss

    model = _scalable(cuda_device, K)
    act, V = distillation_targets(build_yolo_backbone(5, device=cuda_device), 3)
    x = torch.rand((2, 64, 128, 3), generator=torch.Generator(device=cuda_device).manual_seed(0),
                   device=cuda_device)
    mix = 2 if K > 1 else 0
    assert _launched(lambda: model(x, training=False)) == {
        "gdn": 9, "gmm_logp": mix, "gdn_backward": 0, "gmm_logp_backward": 0,
        "gdn_backward_params": 0}
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    assert _launched(lambda: vision_rd_loss(model(x, training=True, generator=gen), x, 0.01, 1.0,
                                            act, V)["loss"].backward()) == {
        "gdn": 9, "gmm_logp": mix, "gdn_backward": 9, "gmm_logp_backward": mix,
        "gdn_backward_params": 9}


@pytest.mark.cuda
def test_latent_space_transform_matches_cpu_on_card(cuda_device, monkeypatch):
    from neural_image_compression_tpu_torch.models import LatentSpaceTransform

    # convolutions in full float32 on the card, as on the CPU (cuDNN's TF32
    # is on by default)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cpu = LatentSpaceTransform(16, device="cpu", generator=torch.Generator().manual_seed(4))
    card = LatentSpaceTransform(16, device=cuda_device)
    card.load_state_dict(cpu.state_dict())
    y1 = torch.round(3 * torch.randn((2, 16, 4, 8), generator=torch.Generator().manual_seed(5)))
    y1 = y1.contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        want = cpu(y1)
        got = card(y1.to(cuda_device)).cpu()
    assert got.shape == want.shape == (2, 32, 8, 16)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_scalable_codec_round_trip_on_card(cuda_device):
    """compress, the full decode and the base layer alone: the eval
    forward's latents exactly, its F_tilde from the base stream, 3 GDN
    launches a call."""
    from neural_image_compression_tpu_torch.coding import ScalableCodec

    model = _scalable(cuda_device, 1)
    codec = ScalableCodec(model)
    x = np.random.default_rng(0).uniform(size=(1, 64, 128, 3)).astype(np.float32)
    with torch.no_grad():
        out = model(torch.from_numpy(x).to(cuda_device), training=False)
    data = codec.compress(x)
    y_q, z_q = codec.decode_latents(data)
    np.testing.assert_array_equal(y_q, out["y_in"][0].cpu().numpy())
    np.testing.assert_array_equal(z_q, out["z_in"][0].cpu().numpy())
    base = codec.truncate_base(data)
    assert _launched(lambda: codec.decompress_base(base))["gdn"] == 3
    y1, f_tilde = codec.decompress_base(base)
    np.testing.assert_array_equal(y1, out["y1"][0].cpu().numpy())
    np.testing.assert_allclose(f_tilde, out["F_tilde"].cpu().numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="enhancement stream missing"):
        codec.decompress(base)
