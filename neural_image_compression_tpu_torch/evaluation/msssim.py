"""SSIM / MS-SSIM in PyTorch on NHWC images, port of evaluation/msssim.py:
Wang et al. 2003 multi-scale SSIM with an 11-tap Gaussian window (sigma
1.5), K1=0.01, K2=0.03, level weights (0.0448, 0.2856, 0.3001, 0.2363,
0.1333), valid convolution, a 2x average pool (zero-padded to even size,
the padding counted) between levels, and ReLU-clamped per-level terms.

The Gaussian blur is two depthwise 1-D convolutions (``F.conv2d`` with
``groups`` = channels), run on the five maps of a level (x, y, x*x, y*y,
x*y) at once. It runs in full float32 whatever the caller has set, forward
and backward (``_Blur``): sigma^2 = E[x^2] - mu^2 cancels, and TF32's
10-bit products, which PyTorch allows in cuDNN's convolutions by default,
would swing MS-SSIM as bfloat16 products did on the TPU.
"""

from typing import Tuple

import torch
import torch.nn.functional as F

from neural_image_compression_tpu_torch.utils.device import fixed_numerics

_DEFAULT_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    coords = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-(coords ** 2) / (2.0 * sigma ** 2))
    return (g / torch.sum(g)).to(device)


class _Blur(torch.autograd.Function):
    """Separable depthwise blur of NCHW x with VALID padding, forward and
    backward under ``fixed_numerics`` (no TF32)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
        c, n = x.shape[1], window.shape[0]
        kh = window.view(1, 1, n, 1).expand(c, 1, n, 1).contiguous()
        kw = window.view(1, 1, 1, n).expand(c, 1, 1, n).contiguous()
        ctx.save_for_backward(kh, kw)
        with fixed_numerics():
            return F.conv2d(F.conv2d(x, kh, groups=c), kw, groups=c)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        kh, kw = ctx.saved_tensors
        c = kh.shape[0]
        with fixed_numerics():
            return F.conv_transpose2d(F.conv_transpose2d(g, kw, groups=c), kh, groups=c), None


def _ssim_per_channel(x, y, window, data_range, k1=0.01, k2=0.03):
    """x, y: NCHW float32 -> (ssim, cs), each (B, C) means over space."""
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    c = x.shape[1]
    blurred = _Blur.apply(torch.cat([x, y, x * x, y * y, x * y], dim=1), window)
    mu_x, mu_y, e_xx, e_yy, e_xy = torch.split(blurred, c, dim=1)
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sigma_xx = e_xx - mu_xx
    sigma_yy = e_yy - mu_yy
    sigma_xy = e_xy - mu_xy
    cs_map = (2.0 * sigma_xy + c2) / (sigma_xx + sigma_yy + c2)
    ssim_map = ((2.0 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs_map
    return ssim_map.mean(dim=(2, 3)), cs_map.mean(dim=(2, 3))


def _avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 average pool of NCHW x, zero-padded by one on both sides
    of an odd dimension, the padding counted in the average."""
    h, w = x.shape[2], x.shape[3]
    return F.avg_pool2d(x, 2, stride=2, padding=(h % 2, w % 2), count_include_pad=True)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.float().permute(0, 3, 1, 2)


def ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
         size_average: bool = True, win_size: int = 11,
         win_sigma: float = 1.5) -> torch.Tensor:
    """Single-scale SSIM over NHWC images: a scalar, or (B,) without
    size_average."""
    window = _gaussian_window(win_size, win_sigma, x.device)
    s, _ = _ssim_per_channel(_nchw(x), _nchw(y), window, data_range)
    return s.mean() if size_average else s.mean(dim=1)


def ms_ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
            size_average: bool = True, win_size: int = 11, win_sigma: float = 1.5,
            weights: Tuple[float, ...] = _DEFAULT_WEIGHTS) -> torch.Tensor:
    """Multi-scale SSIM over NHWC images (pytorch-msssim compatible): a
    scalar, or (B,) without size_average."""
    min_side = min(x.shape[1], x.shape[2])
    needed = (win_size - 1) * 2 ** (len(weights) - 1) + 1
    if min_side < needed:
        raise ValueError(
            f"ms_ssim with {len(weights)} levels and win_size={win_size} needs "
            f"images of at least {needed}px per side, got {min_side}")
    x, y = _nchw(x), _nchw(y)
    window = _gaussian_window(win_size, win_sigma, x.device)
    w = torch.tensor(weights, dtype=torch.float32, device=x.device)
    levels = len(weights)

    mcs = []
    ssim_val = None
    for i in range(levels):
        ssim_val, cs = _ssim_per_channel(x, y, window, data_range)
        if i < levels - 1:
            mcs.append(torch.relu(cs))
            x = _avg_pool2(x)
            y = _avg_pool2(y)
    ssim_val = torch.relu(ssim_val)  # (B, C)
    mcs_and_ssim = torch.stack(mcs + [ssim_val], dim=0)  # (L, B, C)
    out = torch.prod(mcs_and_ssim ** w[:, None, None], dim=0)  # (B, C)
    return out.mean() if size_average else out.mean(dim=1)


def rgb_to_luma(x: torch.Tensor) -> torch.Tensor:
    """BT.601 luma from NHWC RGB in [0,1] -> (B, H, W, 1)."""
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    return (0.299 * r + 0.587 * g + 0.114 * b)[..., None]
