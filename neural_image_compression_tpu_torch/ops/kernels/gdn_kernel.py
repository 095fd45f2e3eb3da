"""GDN / IGDN over (N, C) rows: the hand-written CUDA kernels, forward and
backward, and their plain versions.

Port of neural_image_compression_tpu/ops/pallas/gdn_kernel.py (``fused_gdn``
and ``gdn_fused_op`` with its ``_gdn_fwd``/``_gdn_bwd``). ``gdn`` is
differentiable: where autograd records it, a ``torch.autograd.Function``
saves x, gamma and beta (not the norm) and its backward calls
``gdn_backward``, which recomputes the norm; where neither gamma nor beta
needs a gradient (frozen weights, as in latent refinement) it asks for dx
alone, and the dgamma/dbeta stage does not run. Under ``torch.func``
transforms a second Function, in the ``setup_context`` form with vmap rules
for its forward and its backward, runs the same kernels: a replica axis
folds into the rows (one launch) where gamma and beta are shared and only
dx is asked for, and costs one launch a replica where each replica has its
own gamma and beta or its own dgamma/dbeta (a grid axis over replicas is
later work). Each wrapper launches its kernel
(``csrc/gdn_kernel.cu``, ``csrc/gdn_bwd_kernel.cu``) for CUDA tensors and
runs its plain version (``gdn_reference``, ``gdn_backward_reference``) for
CPU tensors; there is no other dispatch. Under ``no_grad`` or
``inference_mode`` ``gdn`` launches the forward kernel alone.

Both kernels take 1 to 256 channels and load their rows through TMA, which
cannot describe a row stride that is not a multiple of 16 bytes (C % 4 != 0
in float32, C % 8 != 0 in bfloat16; only test widths) or a base address that
is not 16-byte aligned. For those the wrapper copies the rows (x, and g for
the backward) into zero-padded (N, ceil(C/16)*16) rows, pads gamma with
zeros and beta with ones, launches the same kernels and slices the results:
the padded channels add nothing to the others' results.
"""

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

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


def gdn_backward_reference(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                           g: torch.Tensor, inverse: bool = False, param_grads: bool = True):
    """Plain PyTorch backward of ``gdn_reference`` given g = dL/dout, as the
    explicit formula (float32 math; dx in x's dtype, dgamma and dbeta
    float32, or None for both when param_grads is False). With
    n = beta + (x*x) @ gamma, r = n^-1/2 and s = n^1/2:

        GDN:  t = g*x*r^3, dx = g*r - x*(t @ gamma^T), dgamma = -1/2 (x*x)^T @ t
        IGDN: t = g*x/s,   dx = g*s + x*(t @ gamma^T), dgamma = +1/2 (x*x)^T @ t

    and dbeta = -+1/2 sum_rows t."""
    xf, gf = x.float(), g.float()
    sq = xf * xf
    norm = torch.matmul(sq, gamma) + beta
    if inverse:
        root = torch.sqrt(norm)
        t = gf * xf / root
        dx = gf * root + xf * torch.matmul(t, gamma.t())
        half = 0.5
    else:
        r = torch.rsqrt(norm)
        t = gf * xf * (r * r * r)
        dx = gf * r - xf * torch.matmul(t, gamma.t())
        half = -0.5
    if not param_grads:
        return dx.to(x.dtype), None, None
    return dx.to(x.dtype), half * torch.matmul(sq.t(), t), half * torch.sum(t, dim=0)


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("gdn_kernel").gdn_forward
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _backward_entry():
    fn = _build.load("gdn_bwd_kernel").gdn_backward
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, gamma, beta):
    for t in (x, gamma, beta):
        if type(t) not in (torch.Tensor, torch.nn.Parameter):
            raise TypeError(f"the GDN kernels take plain tensors, got {type(t).__name__}")
    _check_shapes(x, gamma, beta)


def _check_shapes(x, gamma, beta):
    """``_check``'s rules of shape, dtype, width, device and layout, which
    hold for the fake tensors of an export too."""
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


class _GDN(torch.autograd.Function):
    """The eager path: autograd applies this form without binding forward's
    arguments through inspect (which setup_context's form does on every
    call, tens of microseconds of host time)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, inverse):
        ctx.save_for_backward(x, gamma, beta)
        ctx.inverse = inverse
        return _forward(x, gamma, beta, inverse)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, gamma, beta = ctx.saved_tensors
        _, needs_gamma, needs_beta, _ = ctx.needs_input_grad
        return (*gdn_backward(x, gamma, beta, g, ctx.inverse, needs_gamma or needs_beta), None)


def _front(t, bdim, size):
    """t with its vmap batch dimension moved to the front, or expanded to
    ``size`` there where it has none."""
    return t.movedim(bdim, 0) if bdim is not None else t.expand(size, *t.shape)


class _GDNBackward(torch.autograd.Function):
    """``gdn_backward`` as a Function with a vmap rule, so that the
    backward of ``_GDNTransformable`` runs under ``torch.func.vmap``. Not
    differentiable itself (the kernels have no double backward)."""

    @staticmethod
    def forward(x, gamma, beta, g, inverse, param_grads):
        return gdn_backward(x, gamma, beta, g, inverse, param_grads)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise RuntimeError("the GDN backward kernel has no backward of its own")

    @staticmethod
    def vmap(info, in_dims, x, gamma, beta, g, inverse, param_grads):
        n = info.batch_size
        x, g = _front(x, in_dims[0], n), _front(g, in_dims[3], n)
        if x.dim() != 3:
            raise ValueError(f"x must be (N, C) rows, got shape {tuple(x.shape[1:])}")
        if in_dims[1] is None and in_dims[2] is None and not param_grads:
            # shared gamma and beta, dx alone: the replicas' rows are one batch of rows
            dx, _, _ = _GDNBackward.apply(x.reshape(-1, x.shape[-1]).contiguous(), gamma, beta,
                                          g.reshape(-1, g.shape[-1]), inverse, False)
            return (dx.view(x.shape), None, None), (0, None, None)
        # one launch a replica: each has its own gamma/beta or its own dgamma/dbeta
        gamma, beta = _front(gamma, in_dims[1], n), _front(beta, in_dims[2], n)
        outs = [_GDNBackward.apply(x[i].contiguous(), gamma[i].contiguous(),
                                   beta[i].contiguous(), g[i], inverse, param_grads)
                for i in range(n)]
        dx = torch.stack([o[0] for o in outs])
        if not param_grads:
            return (dx, None, None), (0, None, None)
        return ((dx, torch.stack([o[1] for o in outs]), torch.stack([o[2] for o in outs])),
                (0, 0, 0))


class _GDNTransformable(torch.autograd.Function):
    """The GDN forward with its backward and a vmap rule, for calls under
    ``torch.func`` transforms (``grad``, ``vmap``), where it still launches
    the kernels: there is no fallback to the plain versions."""

    @staticmethod
    def forward(x, gamma, beta, inverse):
        return _forward(x, gamma, beta, inverse)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, gamma, beta, inverse = inputs
        ctx.save_for_backward(x, gamma, beta)
        ctx.inverse = inverse

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta = ctx.saved_tensors
        _, needs_gamma, needs_beta, _ = ctx.needs_input_grad
        dx, dgamma, dbeta = _GDNBackward.apply(x, gamma, beta, g, ctx.inverse,
                                               needs_gamma or needs_beta)
        return dx, dgamma, dbeta, None

    @staticmethod
    def vmap(info, in_dims, x, gamma, beta, inverse):
        n = info.batch_size
        x = _front(x, in_dims[0], n)
        if x.dim() != 3:
            raise ValueError(f"x must be (N, C) rows, got shape {tuple(x.shape[1:])}")
        if in_dims[1] is None and in_dims[2] is None:
            # shared gamma and beta: the replicas' rows are one batch of rows, one launch
            out = _GDNTransformable.apply(x.reshape(-1, x.shape[-1]).contiguous(), gamma, beta,
                                          inverse)
            return out.view(x.shape), 0
        # each replica its own gamma and beta: one launch a replica
        gamma, beta = _front(gamma, in_dims[1], n), _front(beta, in_dims[2], n)
        return torch.stack([_GDNTransformable.apply(x[i].contiguous(), gamma[i].contiguous(),
                                                    beta[i].contiguous(), inverse)
                            for i in range(n)]), 0


@torch.library.custom_op("nic_torch::gdn", mutates_args=())
def gdn_op(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
           inverse: bool) -> torch.Tensor:
    """The GDN forward as an operator of its own, forward only: what
    ``torch.export`` records in a graph in place of the kernel's call, so an
    exported program launches the kernel where it runs on a CUDA device and
    runs the plain version on the CPU, as ``gdn`` does."""
    return _forward(x, gamma, beta, inverse)


@gdn_op.register_fake
def _(x, gamma, beta, inverse):
    _check_shapes(x, gamma, beta)
    return torch.empty_like(x)


def gdn(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
        inverse: bool = False) -> torch.Tensor:
    """x: (N, C) float32|bfloat16; gamma: (C, C) [in -> out]; beta: (C,).

    gamma and beta arrive reparametrized (ops/bound.nonneg). Returns (N, C)
    in x's dtype, computed in float32; differentiable in x, gamma and beta,
    also under ``torch.func.grad`` and ``torch.func.vmap``. While
    ``torch.export`` traces, the call is recorded as ``gdn_op``.
    """
    if torch.compiler.is_exporting():
        return gdn_op(x, gamma, beta, inverse)
    if torch._C._are_functorch_transforms_active():
        return _GDNTransformable.apply(x, gamma, beta, inverse)
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        return _GDN.apply(x, gamma, beta, inverse)
    return _forward(x, gamma, beta, inverse)


def _forward(x, gamma, beta, inverse):
    _check(x, gamma, beta)
    if x.device.type == "cpu":
        return gdn_reference(x, gamma, beta, inverse)
    if x.device.type != "cuda":
        raise ValueError(f"no GDN kernel for device {x.device}")
    n, c = x.shape
    if n == 0 or c == 0:
        return torch.empty_like(x)
    cp = _padded_width(c, x.element_size(), (x.data_ptr(),))
    if cp is not None:
        return _launch(_pad_rows(x, cp), *_pad_params(gamma, beta, cp), inverse)[:, :c].contiguous()
    return _launch(x, gamma, beta, inverse)


def _padded_width(c: int, element_size: int, addresses):
    """None where TMA can describe rows of c channels as they are (a row
    stride that is a multiple of 16 bytes, every base address 16-byte
    aligned); else the width of the aligned, zero-padded copies the kernels
    run on: c rounded up to a multiple of 16."""
    if (c * element_size) % 16 or any(a % 16 for a in addresses):
        return -(-c // 16) * 16
    return None


def _pad_rows(rows, cp):
    out = rows.new_zeros((rows.shape[0], cp))
    out[:, :rows.shape[1]] = rows
    return out


def _pad_params(gamma, beta, cp):
    """gamma padded with zeros and beta with ones to cp channels: the padded
    channels' norm is 1 and they mix into no other channel."""
    c = beta.shape[0]
    gp = gamma.new_zeros((cp, cp))
    gp[:c, :c] = gamma
    bp = beta.new_ones(cp)
    bp[:c] = beta
    return gp, bp


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


# csrc/gdn_wide.cuh's `Wide`, the launch geometry of its cluster loop: the
# forward and the backward's norm and mix at C > 128, the backward's fused
# launch at 65 to 128 channels
_SMEM_LIMIT, _SMEM_RESERVE = 232448, 2048
WIDE_LAUNCHES = ("forward", "norm", "mix", "backward")


def wide_geometry(c: int, element_size: int, launch: str = "forward") -> dict:
    """The launch geometry of csrc/gdn_wide.cuh's cluster loop, as it
    computes it (tests hold the two together), for ``launch``: at c from 129
    to 256 channels the forward, or the backward's norm (x tiles) or mix
    (float32 t tiles, whatever x's ``element_size``); at c from 65 to 128
    the backward's fused launch ("backward": x tiles, gamma's P planes in
    x's type and Q planes in TF32, and an ``exchange`` buffer of t between
    the cluster's blocks, in bytes a block). The padded width ``cp``, blocks
    a ``cluster``, output channels a block ``nb``, ``consumers`` (warpgroups
    of 64 rows sharing each tile of ``tile_rows``), ring ``stages`` (boxes
    of ``tile_rows`` rows x 128 bytes) and dynamic shared memory ``smem`` in
    bytes a block."""
    if launch not in WIDE_LAUNCHES:
        raise ValueError(f"launch must be one of {WIDE_LAUNCHES}, not {launch!r}")
    fused = launch == "backward"
    if fused and not 64 < c <= 128:
        raise ValueError(f"the fused backward launch takes 65 to 128 channels, not {c}")
    if not fused and not 128 < c <= MAX_CHANNELS:
        raise ValueError(f"the wide loop takes 129 to {MAX_CHANNELS} channels, not {c}")
    esz = 4 if launch == "mix" else element_size
    cp = -(-c // 64) * 64
    f32 = esz == 4
    cluster = 4 if f32 and cp == 256 else 2
    consumers = 2 if launch != "forward" else 3
    nb = cp // cluster
    plane = nb * cp * esz
    q_plane = nb * cp * 4 if fused else 0
    exchange = consumers * 128 * (nb // 2) * 4 if fused else 0
    tile_rows = 64 * consumers
    box = tile_rows * 128
    stages = (_SMEM_LIMIT - _SMEM_RESERVE - 2 * plane - 2 * q_plane - exchange) // box
    barriers = 2 * stages + (2 * consumers if fused else 0)
    smem = 1024 + 2 * plane + 2 * q_plane + exchange + stages * box + nb * 4 + barriers * 8
    geo = dict(cp=cp, cluster=cluster, nb=nb, consumers=consumers, tile_rows=tile_rows,
               stages=stages, smem=smem)
    if fused:
        geo["exchange"] = exchange
    return geo


def _chunking(n: int):
    """(rows per chunk, chunks) of the backward kernel's dgamma partials: at
    most 256 chunks of at least 256 rows, a function of n alone, so the sums
    run in one order for a given shape."""
    rows = max(256, -(-n // 256))
    rows = -(-rows // 32) * 32
    return rows, -(-n // rows)


def gdn_backward(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 g: torch.Tensor, inverse: bool = False, param_grads: bool = True):
    """Backward of ``gdn`` given g = dL/dout (x's shape and dtype) -> (dx in
    x's dtype, dgamma (C, C) float32, dbeta (C,) float32). g may come in any
    layout; a strided g is copied into contiguous rows first. With
    param_grads False the dgamma/dbeta stage (the partials and reduce
    launches) does not run and both come back None. ``gdn_backward.launches``
    counts the calls that launch the kernel, ``gdn_backward.param_launches``
    those of them that run the dgamma/dbeta stage."""
    _check(x, gamma, beta)
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"g must match x: {tuple(x.shape)} {x.dtype} on {x.device}, got "
                         f"{tuple(g.shape)} {g.dtype} on {g.device}")
    g = g.contiguous()
    if x.device.type == "cpu":
        return gdn_backward_reference(x, gamma, beta, g, inverse, param_grads)
    if x.device.type != "cuda":
        raise ValueError(f"no GDN backward kernel for device {x.device}")
    n, c = x.shape
    if n == 0 or c == 0:
        if not param_grads:
            return torch.zeros_like(x), None, None
        return torch.zeros_like(x), torch.zeros_like(gamma), torch.zeros_like(beta)
    cp = _padded_width(c, x.element_size(), (x.data_ptr(), g.data_ptr()))
    if cp is not None:
        dx, dgamma, dbeta = _launch_backward(_pad_rows(x, cp), *_pad_params(gamma, beta, cp),
                                             _pad_rows(g, cp), inverse, param_grads)
        if not param_grads:
            return dx[:, :c].contiguous(), None, None
        return dx[:, :c].contiguous(), dgamma[:c, :c].contiguous(), dbeta[:c].contiguous()
    return _launch_backward(x, gamma, beta, g, inverse, param_grads)


def _scratch_floats(n: int, c: int, bf16: bool, param_grads: bool, chunks: int) -> int:
    """Float32 values of the backward's scratch, in the C entry point's
    layout. From 65 to 128 channels the fused launch keeps t and d1 in
    registers: t (n, c) only for the dgamma/dbeta stage, which reads it. At
    the other widths t (n, c) and, for bfloat16 rows, d1 (n, c). Then, with
    the dgamma/dbeta stage, each chunk's dgamma and dbeta partials."""
    rows = (1 if param_grads else 0) if 64 < c <= 128 else 2 if bf16 else 1
    return n * c * rows + (chunks * c * (c + 1) if param_grads else 0)


def _launch_backward(x, gamma, beta, g, inverse, param_grads):
    n, c = x.shape
    bf16 = x.dtype == torch.bfloat16
    dx = torch.empty_like(x)
    dgamma = torch.empty_like(gamma) if param_grads else None
    dbeta = torch.empty_like(beta) if param_grads else None
    chunk_rows, chunks = _chunking(n)
    floats = _scratch_floats(n, c, bf16, param_grads, chunks)
    scratch = torch.empty(floats, dtype=torch.float32, device=x.device) if floats else None
    with torch.cuda.device(x.device):
        err = _backward_entry()(
            x.data_ptr(), g.data_ptr(), gamma.data_ptr(), beta.data_ptr(), dx.data_ptr(),
            dgamma.data_ptr() if param_grads else None,
            dbeta.data_ptr() if param_grads else None,
            scratch.data_ptr() if scratch is not None else None, n, c, chunk_rows, chunks,
            int(inverse), int(bf16), torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"gdn backward kernel launch failed with CUDA error {err}")
    gdn_backward.launches += 1
    gdn_backward.param_launches += int(param_grads)
    return dx, dgamma, dbeta


gdn.launches = 0
gdn_backward.launches = 0
gdn_backward.param_launches = 0
