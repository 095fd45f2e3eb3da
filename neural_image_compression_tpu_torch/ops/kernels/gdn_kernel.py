"""GDN / IGDN over (N, C) rows: the hand-written CUDA kernel and its plain
version.

Port of neural_image_compression_tpu/ops/pallas/gdn_kernel.py (``fused_gdn``).
``gdn`` launches ``csrc/gdn_kernel.cu`` for CUDA tensors and runs
``gdn_reference`` for CPU tensors; there is no other dispatch. Forward only:
the backward kernel comes with the training forward.

The kernel takes 1 to 256 channels and loads x through TMA, which cannot
describe a row stride that is not a multiple of 16 bytes (C % 4 != 0 in
float32, C % 8 != 0 in bfloat16; only test widths) or a base address that
is not 16-byte aligned. For those the wrapper copies x into zero-padded
(N, ceil(C/16)*16) rows, pads gamma with zeros and beta with ones, launches
the same kernel and slices the result.
"""

import ctypes
import functools

import torch

from neural_image_compression_tpu_torch.ops.kernels import _build

_DTYPES = (torch.float32, torch.bfloat16)
MAX_CHANNELS = 256  # the widest GDN of the JAX package's configurations is 192


def gdn_reference(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  inverse: bool = False) -> torch.Tensor:
    """Plain PyTorch GDN over rows: float32 math, result in x's dtype."""
    xf = x.float()
    norm = torch.matmul(xf * xf, gamma) + beta
    out = xf * (torch.sqrt(norm) if inverse else torch.rsqrt(norm))
    return out.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("gdn_kernel").gdn_forward
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, gamma, beta):
    if x.dim() != 2:
        raise ValueError(f"x must be (N, C) rows, got shape {tuple(x.shape)}")
    c = x.shape[1]
    if c > MAX_CHANNELS:
        raise ValueError(f"at most {MAX_CHANNELS} channels, got {c}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if gamma.shape != (c, c) or beta.shape != (c,):
        raise ValueError(f"gamma must be ({c}, {c}) and beta ({c},), got "
                         f"{tuple(gamma.shape)} and {tuple(beta.shape)}")
    if gamma.dtype != torch.float32 or beta.dtype != torch.float32:
        raise TypeError("gamma and beta must be float32")
    if gamma.device != x.device or beta.device != x.device:
        raise ValueError("x, gamma and beta must be on one device")
    if not (x.is_contiguous() and gamma.is_contiguous() and beta.is_contiguous()):
        raise ValueError("x, gamma and beta must be contiguous")


def gdn(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
        inverse: bool = False) -> torch.Tensor:
    """x: (N, C) float32|bfloat16; gamma: (C, C) [in -> out]; beta: (C,).

    gamma and beta arrive reparametrized (ops/bound.nonneg). Returns (N, C)
    in x's dtype, computed in float32.
    """
    _check(x, gamma, beta)
    if x.device.type == "cpu":
        return gdn_reference(x, gamma, beta, inverse)
    if x.device.type != "cuda":
        raise ValueError(f"no GDN kernel for device {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        raise NotImplementedError("GDN backward kernel: training slice")
    n, c = x.shape
    if n == 0 or c == 0:
        return torch.empty_like(x)
    if (c * x.element_size()) % 16 or x.data_ptr() % 16:
        cp = -(-c // 16) * 16
        xp = x.new_zeros((n, cp))
        xp[:, :c] = x
        gp = gamma.new_zeros((cp, cp))
        gp[:c, :c] = gamma
        bp = beta.new_ones(cp)
        bp[:c] = beta
        return _launch(xp, gp, bp, inverse)[:, :c].contiguous()
    return _launch(x, gamma, beta, inverse)


def _launch(x, gamma, beta, inverse):
    n, c = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _entry()(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                       out.data_ptr(), n, c, int(inverse),
                       int(x.dtype == torch.bfloat16),
                       torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"gdn kernel launch failed with CUDA error {err}")
    gdn.launches += 1
    return out


gdn.launches = 0
