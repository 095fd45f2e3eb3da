"""Discretized Gaussian-mixture log-likelihood: the hand-written CUDA kernel
and its plain version.

Port of neural_image_compression_tpu/ops/pallas/gmm_kernel.py
(``fused_mixture_log_likelihood``), computed with exact erf as the JAX
package's plain path (entropy/gaussian.py) does, not with the Pallas kernel's
clipped rational erf. ``gmm_logp`` launches ``csrc/gmm_kernel.cu`` for CUDA
tensors and runs ``mixture_log_likelihood_reference`` for CPU tensors; there
is no other dispatch. Forward only.
"""

import ctypes
import functools

import torch

from neural_image_compression_tpu_torch.entropy.base import DEFAULT_LIKELIHOOD_LOWER_BOUND
from neural_image_compression_tpu_torch.ops.kernels import _build
from neural_image_compression_tpu_torch.ops.math import gaussian_cdf

MAX_K = 8


def mixture_log_likelihood_reference(y: torch.Tensor, weights: torch.Tensor,
                                     mus: torch.Tensor,
                                     sigmas: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: y (N, M); weights/mus/sigmas (N, K, M). The
    operations and their order are entropy/gaussian.py's mixture_likelihood."""
    y_exp = y[:, None, :]
    inv_s = 1.0 / sigmas
    upper = gaussian_cdf((y_exp + 0.5 - mus) * inv_s)
    lower = gaussian_cdf((y_exp - 0.5 - mus) * inv_s)
    p = torch.sum(weights * (upper - lower), dim=1)
    return torch.log(torch.clamp_min(p, DEFAULT_LIKELIHOOD_LOWER_BOUND))


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("gmm_kernel").gmm_logp_forward
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(y, weights, mus, sigmas):
    if y.dim() != 2:
        raise ValueError(f"y must be (N, M), got shape {tuple(y.shape)}")
    n, m = y.shape
    if weights.dim() != 3 or weights.shape[0] != n or weights.shape[2] != m:
        raise ValueError(f"weights must be ({n}, K, {m}), got {tuple(weights.shape)}")
    k = weights.shape[1]
    if not 1 <= k <= MAX_K:
        raise ValueError(f"K must be in 1..{MAX_K}, got {k}")
    for name, t in (("mus", mus), ("sigmas", sigmas)):
        if t.shape != weights.shape:
            raise ValueError(f"{name} must be {tuple(weights.shape)}, got {tuple(t.shape)}")
    for name, t in (("y", y), ("weights", weights), ("mus", mus), ("sigmas", sigmas)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != y.device:
            raise ValueError("y, weights, mus and sigmas must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def gmm_logp(y: torch.Tensor, weights: torch.Tensor, mus: torch.Tensor,
             sigmas: torch.Tensor) -> torch.Tensor:
    """log(max(sum_k w * (Phi(u) - Phi(l)), 1e-9)) -> (N, M) float32."""
    _check(y, weights, mus, sigmas)
    if y.device.type == "cpu":
        return mixture_log_likelihood_reference(y, weights, mus, sigmas)
    if y.device.type != "cuda":
        raise ValueError(f"no mixture-likelihood kernel for device {y.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (y, weights, mus, sigmas)):
        raise NotImplementedError("mixture-likelihood backward kernel: training slice")
    n, m = y.shape
    out = torch.empty_like(y)
    if n == 0 or m == 0:
        return out
    with torch.cuda.device(y.device):
        err = _entry()(y.data_ptr(), weights.data_ptr(), mus.data_ptr(),
                       sigmas.data_ptr(), out.data_ptr(), n, weights.shape[1], m,
                       torch.cuda.current_stream(y.device).cuda_stream)
    if err:
        raise RuntimeError(f"gmm kernel launch failed with CUDA error {err}")
    gmm_logp.launches += 1
    return out


gmm_logp.launches = 0
