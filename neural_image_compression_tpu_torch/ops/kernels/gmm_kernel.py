"""Discretized Gaussian-mixture log-likelihood: the hand-written CUDA kernels,
forward and backward, and their plain versions.

Port of neural_image_compression_tpu/ops/pallas/gmm_kernel.py
(``fused_mixture_log_likelihood``), computed with exact erf as the JAX
package's plain path (entropy/gaussian.py) does, not with the Pallas kernel's
clipped rational erf. The JAX package has no backward kernel: its training
autodiffs that plain path and ``jnp.log``. Here ``gmm_logp`` is
differentiable: where autograd records it, a ``torch.autograd.Function``
saves its inputs and its backward calls ``gmm_logp_backward``, which
recomputes the likelihood. Under ``torch.func`` transforms a second
Function with vmap rules, forward and backward, runs the same kernels: a
replica axis folds into the rows, one launch for all replicas. Each wrapper launches its entry of
``csrc/gmm_kernel.cu`` for CUDA tensors and runs its plain version
(``mixture_log_likelihood_reference``,
``mixture_log_likelihood_backward_reference``) for CPU tensors; there is no
other dispatch. The public functions check their inputs; the autograd and
vmap routes launch the backward on tensors their forward has checked,
without checking them again. ``mixture_geometry`` mirrors the kernels'
launch geometry (row tiles, ring stages, shared memory, grid).
"""

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from neural_image_compression_tpu_torch.entropy.base import DEFAULT_LIKELIHOOD_LOWER_BOUND
from neural_image_compression_tpu_torch.ops.kernels import _build
from neural_image_compression_tpu_torch.ops.math import gaussian_cdf

MAX_K = 8
INV_SQRT_2PI = 0.3989422804014327


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


def mixture_log_likelihood_backward_reference(y: torch.Tensor, weights: torch.Tensor,
                                              mus: torch.Tensor, sigmas: torch.Tensor,
                                              g: torch.Tensor):
    """Plain PyTorch backward of ``mixture_log_likelihood_reference`` given
    g = dL/dlogp (N, M), as the explicit formula -> (dy, dweights, dmus,
    dsigmas). With u, l the bin edges over sigma, phi the standard normal
    density and G = g / p where p >= 1e-9 (0 below the floor):
    dw = G (Phi(u) - Phi(l)), dmu = -G w (phi(u) - phi(l)) / sigma,
    dsigma = -G w (phi(u) u - phi(l) l) / sigma, dy = -sum_k dmu."""
    y_exp = y[:, None, :]
    inv_s = 1.0 / sigmas
    u = (y_exp + 0.5 - mus) * inv_s
    l = (y_exp - 0.5 - mus) * inv_s
    mass = gaussian_cdf(u) - gaussian_cdf(l)
    p = torch.sum(weights * mass, dim=1)
    gp = torch.where(p >= DEFAULT_LIKELIHOOD_LOWER_BOUND,
                     g / torch.clamp_min(p, DEFAULT_LIKELIHOOD_LOWER_BOUND), 0.0)[:, None, :]
    pdf_u = INV_SQRT_2PI * torch.exp(-0.5 * u * u)
    pdf_l = INV_SQRT_2PI * torch.exp(-0.5 * l * l)
    a = gp * weights * inv_s
    dmus = -a * (pdf_u - pdf_l)
    return -torch.sum(dmus, dim=1), gp * mass, dmus, -a * (pdf_u * u - pdf_l * l)


# csrc/gmm_kernel.cu's geometry, mirrored: 8 consumer warps and a producer
# warp a block; tiles of rows in fours, about 512 positions each (1,024
# where a block takes at least 16 such); a ring of 2 to 8 stages past the
# 128 bytes of mbarriers; two blocks an SM where two stages fit in half an
# SM's shared memory
_THREADS = 288
_MAX_STAGES, _MIN_STAGES = 8, 2
_ROW_STEP, _TILE_POSITIONS, _BIG_TILES_PER_BLOCK = 4, 512, 16
_HEADER = 2 * _MAX_STAGES * 8
_SMEM_SM, _SMEM_BLOCK_RESERVE, _SMEM_LIMIT = 233472, 1024, 232448
_SMEM_HALF = _SMEM_SM // 2 - _SMEM_BLOCK_RESERVE
H100_SMS = 132


def _resident_by_smem(smem: int) -> int:
    """Blocks an SM holds by threads and shared memory alone."""
    return min(2048 // _THREADS, _SMEM_SM // (smem + _SMEM_BLOCK_RESERVE))


def _ring(k: int, m: int, backward: bool, positions: int):
    """csrc/gmm_kernel.cu's geometry(): (rows, stages, stage bytes, blocks an
    SM) of tiles of about ``positions`` positions; no stages: no ring."""
    row_bytes = 4 * m * (3 * k + (2 if backward else 1))
    rows = max(_ROW_STEP, positions // m // _ROW_STEP * _ROW_STEP)
    while rows > _ROW_STEP and _HEADER + _MIN_STAGES * rows * row_bytes > _SMEM_HALF:
        rows -= _ROW_STEP
    stage = rows * row_bytes
    blocks = 2 if _HEADER + _MIN_STAGES * stage <= _SMEM_HALF else 1
    stages = min(_MAX_STAGES, ((_SMEM_HALF if blocks == 2 else _SMEM_LIMIT) - _HEADER) // stage)
    if stages < _MIN_STAGES:
        return rows, 0, stage, 2
    return rows, stages, stage, blocks


def mixture_geometry(n: int, k: int, m: int, backward: bool = False, sms: int = H100_SMS,
                     resident=_resident_by_smem) -> dict:
    """The launch geometry of csrc/gmm_kernel.cu's forward (or backward)
    over n rows of K components and M channels, as the C entry point
    computes it (tests hold the two together) for a card of ``sms`` SMs:
    ``rows`` a tile (a multiple of 4), ring ``stages`` (0: every tile is
    read straight from device memory, as is every tile of a call whose
    pointers are not 16-byte aligned), dynamic shared memory ``smem`` in
    bytes a block, ``blocks_per_sm``, ``tiles``, ``ring_tiles`` (the whole
    tiles, which go through the ring; the last, ragged tile does not) and
    the persistent ``grid``. Tiles aim at 512 positions, or at 1,024 where a
    block would still take 16 of those. Where a block would take fewer
    tiles than the ring has stages, the ring shrinks to that many and the
    grid grows to as many blocks as an SM holds at that size:
    ``resident(smem)``, which the C entry point takes from CUDA's
    occupancy calculator (registers count there too); where a block then
    takes one tile, it reads it directly (no ring)."""
    rows, stages, stage, blocks = _ring(k, m, backward, _TILE_POSITIONS)
    big = _ring(k, m, backward, 2 * _TILE_POSITIONS)
    if big[1] and n // big[0] >= _BIG_TILES_PER_BLOCK * sms * big[3]:
        rows, stages, stage, blocks = big
    tiles = -(-n // rows)
    grid = min(tiles, sms * blocks)
    per_block = -(-tiles // grid) if grid else 0
    if 0 < per_block < stages:
        blocks = max(blocks, resident(_HEADER + per_block * stage))
        grid = min(tiles, sms * blocks)
        per_block = -(-tiles // grid)
        stages = per_block if per_block > 1 else 0
    return dict(rows=rows, stages=stages, smem=_HEADER + stages * stage if stages else 0,
                blocks_per_sm=blocks, tiles=tiles, ring_tiles=n // rows if stages else 0,
                grid=grid)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("gmm_kernel").gmm_logp_forward
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _backward_entry():
    fn = _build.load("gmm_kernel").gmm_logp_backward
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(y, weights, mus, sigmas):
    for t in (y, weights, mus, sigmas):
        if type(t) not in (torch.Tensor, torch.nn.Parameter):
            raise TypeError(f"the mixture kernels take plain tensors, got {type(t).__name__}")
    _check_shapes(y, weights, mus, sigmas)


def _check_shapes(y, weights, mus, sigmas):
    """``_check``'s rules of shape, dtype, K, device and layout, which hold
    for the fake tensors of an export too."""
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


class _MixtureLogLikelihood(torch.autograd.Function):
    """The eager path (the form autograd applies without inspecting
    forward's signature)."""

    @staticmethod
    def forward(ctx, y, weights, mus, sigmas):
        ctx.save_for_backward(y, weights, mus, sigmas)
        return _forward(y, weights, mus, sigmas)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _launch_backward(*ctx.saved_tensors, g)


def _folded(info, in_dims, tensors):
    """The vmapped tensors with their batch dimension in front (expanded
    where they have none), folded into their rows: (L, N, ...) -> (L*N, ...)."""
    n = info.batch_size
    out = []
    for t, bdim in zip(tensors, in_dims):
        t = t.movedim(bdim, 0) if bdim is not None else t.expand(n, *t.shape)
        out.append(t.reshape(-1, *t.shape[2:]).contiguous())
    return out


class _MixtureBackward(torch.autograd.Function):
    """``gmm_logp_backward`` as a Function with a vmap rule (not
    differentiable itself)."""

    @staticmethod
    def forward(y, weights, mus, sigmas, g):
        return _launch_backward(y, weights, mus, sigmas, g)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("the mixture backward kernel has no backward of its own")

    @staticmethod
    def vmap(info, in_dims, y, weights, mus, sigmas, g):
        if y.dim() - (in_dims[0] is not None) != 2:
            raise ValueError(f"y must be (N, M), got {y.dim() - (in_dims[0] is not None)} dims")
        n = info.batch_size
        grads = _MixtureBackward.apply(*_folded(info, in_dims, (y, weights, mus, sigmas, g)))
        return tuple(t.view(n, -1, *t.shape[1:]) for t in grads), (0, 0, 0, 0)


class _MixtureTransformable(torch.autograd.Function):
    """The mixture log-likelihood with its backward and a vmap rule, for
    calls under ``torch.func`` transforms: every input is per row, so a
    replica axis folds into the rows and one launch serves all replicas,
    forward and backward."""

    @staticmethod
    def forward(y, weights, mus, sigmas):
        return _forward(y, weights, mus, sigmas)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        return _MixtureBackward.apply(*ctx.saved_tensors, g)

    @staticmethod
    def vmap(info, in_dims, y, weights, mus, sigmas):
        if y.dim() - (in_dims[0] is not None) != 2:
            raise ValueError(f"y must be (N, M), got {y.dim() - (in_dims[0] is not None)} dims")
        out = _MixtureTransformable.apply(*_folded(info, in_dims, (y, weights, mus, sigmas)))
        return out.view(info.batch_size, -1, out.shape[-1]), 0


@torch.library.custom_op("nic_torch::gmm_logp", mutates_args=())
def gmm_logp_op(y: torch.Tensor, weights: torch.Tensor, mus: torch.Tensor,
                sigmas: torch.Tensor) -> torch.Tensor:
    """The mixture forward as an operator of its own, forward only: what
    ``torch.export`` records in a graph in place of the kernel's call (the
    kernel on a CUDA device, the plain version on the CPU, as ``gmm_logp``)."""
    return _forward(y, weights, mus, sigmas)


@gmm_logp_op.register_fake
def _(y, weights, mus, sigmas):
    _check_shapes(y, weights, mus, sigmas)
    return torch.empty_like(y)


def gmm_logp(y: torch.Tensor, weights: torch.Tensor, mus: torch.Tensor,
             sigmas: torch.Tensor) -> torch.Tensor:
    """log(max(sum_k w * (Phi(u) - Phi(l)), 1e-9)) -> (N, M) float32;
    differentiable in every input, also under ``torch.func.grad`` and
    ``torch.func.vmap``. While ``torch.export`` traces, the call is
    recorded as ``gmm_logp_op``."""
    if torch.compiler.is_exporting():
        return gmm_logp_op(y, weights, mus, sigmas)
    if torch._C._are_functorch_transforms_active():
        return _MixtureTransformable.apply(y, weights, mus, sigmas)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (y, weights, mus, sigmas)):
        return _MixtureLogLikelihood.apply(y, weights, mus, sigmas)
    return _forward(y, weights, mus, sigmas)


def _forward(y, weights, mus, sigmas):
    _check(y, weights, mus, sigmas)
    return _launch_forward(y, weights, mus, sigmas)


def _on_device(fn, device, *args):
    """``fn(*args, stream)`` with ``device`` current, on its current stream."""
    index = device.index
    if index == torch._C._cuda_getDevice():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def _launch_forward(y, weights, mus, sigmas):
    """The forward on checked tensors."""
    if y.device.type == "cpu":
        return mixture_log_likelihood_reference(y, weights, mus, sigmas)
    if y.device.type != "cuda":
        raise ValueError(f"no mixture-likelihood kernel for device {y.device}")
    n, m = y.shape
    out = torch.empty_like(y)
    if n == 0 or m == 0:
        return out
    err = _on_device(_entry(), y.device, y.data_ptr(), weights.data_ptr(), mus.data_ptr(),
                     sigmas.data_ptr(), out.data_ptr(), n, weights.shape[1], m)
    if err:
        raise RuntimeError(f"gmm kernel launch failed with CUDA error {err}")
    gmm_logp.launches += 1
    return out


def gmm_logp_backward(y: torch.Tensor, weights: torch.Tensor, mus: torch.Tensor,
                      sigmas: torch.Tensor, g: torch.Tensor):
    """Backward of ``gmm_logp`` given g = dL/dlogp (N, M) float32 ->
    (dy, dweights, dmus, dsigmas), float32. g may come in any layout (a
    broadcast from a sum, say); it is made contiguous first."""
    _check(y, weights, mus, sigmas)
    if g.shape != y.shape or g.dtype != torch.float32 or g.device != y.device:
        raise ValueError(f"g must be float32 {tuple(y.shape)} on {y.device}, got "
                         f"{g.dtype} {tuple(g.shape)} on {g.device}")
    return _launch_backward(y, weights, mus, sigmas, g)


def _launch_backward(y, weights, mus, sigmas, g):
    """The backward on checked tensors (a g of y's shape, type and device,
    in any layout)."""
    g = g.contiguous()
    if y.device.type == "cpu":
        return mixture_log_likelihood_backward_reference(y, weights, mus, sigmas, g)
    if y.device.type != "cuda":
        raise ValueError(f"no mixture-likelihood backward kernel for device {y.device}")
    n, m = y.shape
    grads = (torch.empty_like(y), torch.empty_like(weights), torch.empty_like(mus),
             torch.empty_like(sigmas))
    if n == 0 or m == 0:
        return grads
    err = _on_device(_backward_entry(), y.device, y.data_ptr(), weights.data_ptr(),
                     mus.data_ptr(), sigmas.data_ptr(), g.data_ptr(),
                     *(t.data_ptr() for t in grads), n, weights.shape[1], m)
    if err:
        raise RuntimeError(f"gmm backward kernel launch failed with CUDA error {err}")
    gmm_logp_backward.launches += 1
    return grads


gmm_logp.launches = 0
gmm_logp_backward.launches = 0
