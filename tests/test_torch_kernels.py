"""PyTorch port, kernel wrappers: input checks and plain versions on the CPU
and, on a CUDA card only, each hand-written kernel against its plain
version. This file imports no JAX, so it also runs where only the port is
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from neural_image_compression_tpu_torch.ops.kernels import gdn_kernel, gmm_kernel

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


def test_gdn_reference_bf16_keeps_dtype_and_f32_math():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(33, 16)).astype(np.float32)).to(torch.bfloat16)
    g = torch.from_numpy(np.abs(rng.normal(0, 0.1, (16, 16))).astype(np.float32))
    b = torch.ones(16)
    got = gdn_kernel.gdn(x, g, b)
    assert got.dtype == torch.bfloat16
    want = gdn_kernel.gdn_reference(x.float(), g, b).to(torch.bfloat16)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


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
# ragged last row tile; channel counts that fill, and that leave ragged,
# the kernel's 16-channel slices and 64-channel output tiles
@pytest.mark.parametrize("n,c", [(1000, 128), (77, 100), (300, 16), (513, 256)])
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
