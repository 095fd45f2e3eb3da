"""Plain PyTorch layers of the benchmark's reference: float32 operations on
NCHW tensors, each weight read from a dict by its ``state_dict`` name.

Nothing here imports the measured package. The equations are those of the
published models (Balle et al. 2018, Minnen et al. 2018): GDN with its
non-negative reparametrization, the factorized bottleneck's monotone
CDF network, the discretized Gaussian and Gaussian-mixture likelihoods, the
raster-causal masked convolution and the 1x1 entropy-parameter network.

``Numerics`` says how a layer's operands and results are rounded around
the float32 arithmetic: not at all (the reference), or to fp8 e4m3 with one
scale a tensor (the control of a bfloat16 configuration, held where the
program holds bfloat16: each convolution's input, weight and output, and
each GDN's output).
"""

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

LIKELIHOOD_FLOOR = 1e-9
SIGMA_FLOOR = 1e-6
PEDESTAL = (2.0 ** -18) ** 2
GDN_BETA_MIN = 1e-6
HIDDEN = 640
LOG2 = math.log(2.0)
FP8_MAX = 448.0

Params = Dict[str, torch.Tensor]


@dataclass(frozen=True)
class Numerics:
    """operands: "f32" (as they are) or "fp8" (rounded to e4m3, one scale a
    tensor)."""
    operands: str = "f32"

    def round(self, t: torch.Tensor) -> torch.Tensor:
        if self.operands == "f32":
            return t
        if self.operands != "fp8":
            raise ValueError(f"unknown operand precision {self.operands!r}")
        scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
        return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


F32 = Numerics("f32")


class _LowerBound(torch.autograd.Function):
    """max(x, bound); the gradient passes where x >= bound or where it
    pushes x back up (compressai's LowerBound)."""

    @staticmethod
    def forward(ctx, x, bound):
        ctx.save_for_backward(x)
        ctx.bound = bound
        return torch.clamp_min(x, bound)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where((x >= ctx.bound) | (g < 0), g, torch.zeros_like(g)), None


def nonneg(raw: torch.Tensor, minimum: float = 0.0) -> torch.Tensor:
    bounded = _LowerBound.apply(raw, (minimum + PEDESTAL) ** 0.5)
    return bounded * bounded - PEDESTAL


def nonneg_raw(value: torch.Tensor) -> torch.Tensor:
    """The stored form of a non-negative value."""
    return torch.sqrt(torch.clamp_min(value + PEDESTAL, PEDESTAL))


def leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.01)


def conv(p: Params, name: str, x, stride=1, padding=0, num: Numerics = F32, bias=True):
    w = p[f"{name}.weight"]
    b = p.get(f"{name}.bias") if bias else None
    return num.round(F.conv2d(num.round(x), num.round(w), b, stride, padding))


def masked_conv(p: Params, name: str, x, num: Numerics = F32):
    """5x5 raster-causal conv, type A: the taps above the centre row and
    left of the centre."""
    w = p[f"{name}.weight"]
    k = w.shape[-1]
    mask = torch.ones(k, k, device=w.device)
    mask[k // 2, k // 2:] = 0
    mask[k // 2 + 1:] = 0
    return num.round(F.conv2d(num.round(x), num.round(w * mask), p[f"{name}.bias"], 1, k // 2))


def deconv(p: Params, name: str, x, stride=2, padding=2, output_padding=1, num: Numerics = F32):
    """Transposed conv; weight (in, out, k, k)."""
    return num.round(F.conv_transpose2d(num.round(x), num.round(p[f"{name}.weight"]),
                                        p[f"{name}.bias"], stride, padding, output_padding))


def gdn(p: Params, name: str, x, inverse=False, num: Numerics = F32):
    """x * (beta + sum_j gamma_ji x_j^2)^(-1/2) (GDN) or ^(+1/2) (IGDN),
    gamma (C_in, C_out)."""
    beta = nonneg(p[f"{name}.beta"], GDN_BETA_MIN)
    gamma = nonneg(p[f"{name}.gamma"])
    norm = torch.einsum("bihw,io->bohw", x * x, gamma) + beta[None, :, None, None]
    return num.round(x * (torch.sqrt(norm) if inverse else torch.rsqrt(norm)))


def entropy_parameters(p: Params, name: str, combined, m: int, k: int, num: Numerics = F32):
    """Three 1x1 convs (hidden 640, leaky ReLU) -> NHWC float32 (mu, sigma)
    for K = 1, or (weights, mus, sigmas), each (B, h, w, K, M), split
    k-major, weights softmaxed over K."""
    h = leaky(conv(p, f"{name}.Conv2d_0", combined, num=num))
    h = leaky(conv(p, f"{name}.Conv2d_1", h, num=num))
    out = conv(p, f"{name}.Conv2d_2", h, num=num).permute(0, 2, 3, 1)
    if k == 1:
        mu, raw = torch.chunk(out, 2, dim=-1)
        return mu, F.softplus(raw) + SIGMA_FLOOR
    b, hh, ww, _ = out.shape
    w_raw, mu_raw, s_raw = (t.reshape(b, hh, ww, k, m) for t in torch.chunk(out, 3, dim=-1))
    return torch.softmax(w_raw, dim=-2), mu_raw, F.softplus(s_raw) + SIGMA_FLOOR


def _phi(t):
    return 0.5 * (1.0 + torch.erf(t / math.sqrt(2.0)))


def gaussian_logp(y, mu, sigma):
    """log of the bin mass of y under N(mu, sigma), floored at 1e-9."""
    mass = _phi((y + 0.5 - mu) / sigma) - _phi((y - 0.5 - mu) / sigma)
    return torch.log(torch.clamp_min(mass, LIKELIHOOD_FLOOR))


def mixture_logp(y, weights, mus, sigmas):
    """y (B, h, w, M); the mixture (B, h, w, K, M)."""
    yk = y[..., None, :]
    mass = _phi((yk + 0.5 - mus) / sigmas) - _phi((yk - 0.5 - mus) / sigmas)
    return torch.log(torch.clamp_min(torch.sum(weights * mass, dim=-2), LIKELIHOOD_FLOOR))


def conditional_logp(k: int, y, params):
    return gaussian_logp(y, *params) if k == 1 else mixture_logp(y, *params)


FACTORIZED_FILTERS = (3, 3, 3)


def factorized_logp(p: Params, name: str, z):
    """Factorized bottleneck: z NHWC (B, h, w, C) -> log bin mass, the
    likelihood sigmoid(L(z + 1/2)) - sigmoid(L(z - 1/2)) taken on the side
    where both logits are small."""
    b, h, w, c = z.shape
    flat = z.reshape(-1, c).t().reshape(c, 1, -1)
    layers = len(FACTORIZED_FILTERS) + 1

    def logits(t):
        for i in range(layers):
            t = torch.bmm(F.softplus(p[f"{name}.matrix_{i}"]), t) + p[f"{name}.bias_{i}"]
            if i < layers - 1:
                t = t + torch.tanh(p[f"{name}.factor_{i}"]) * torch.tanh(t)
        return t

    lower, upper = logits(flat - 0.5), logits(flat + 0.5)
    sign = -torch.sign(lower + upper).detach()
    mass = torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))
    mass = mass.reshape(c, -1).t().reshape(b, h, w, c)
    return torch.log(torch.clamp_min(mass, LIKELIHOOD_FLOOR))


def quantize(t, training: bool, generator: Optional[torch.Generator]):
    """Eval: round half to even. Train: t + U(-1/2, 1/2), float32, drawn on
    t's device from ``generator`` with the same call the program makes, so
    a generator in the same state gives the same noise."""
    if not training:
        return torch.round(t)
    noise = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    return t + noise.uniform_(-0.5, 0.5, generator=generator)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


def nchw(x):
    return x.permute(0, 3, 1, 2)


def bpp(logp, pixels: int):
    """Bits a pixel of each image: -sum(logp) / ln 2 / pixels."""
    return -torch.sum(logp, dim=tuple(range(1, logp.dim()))) / LOG2 / pixels


# -- parameter specifications ------------------------------------------------

@dataclass(frozen=True)
class Spec:
    """One leaf: its state_dict name, shape and how the benchmark draws it.
    init: "range" (U(lo, hi), or by blocks), "gdn_beta", "gdn_gamma" (the
    stored forms of beta in [0.5, 1.5] and of 0.1 I plus off-diagonal mass
    in (0, 0.002 * 128 / C], never on the bound)."""
    name: str
    shape: tuple
    init: str
    lo: float = 0.0
    hi: float = 0.0
    blocks: tuple = ()  # "range" by consecutive blocks: ((count, lo, hi), ...)


def conv_specs(name, cin, cout, k, gain=1.0, bias=True, transposed=False,
               stride=2) -> List[Spec]:
    """Variance-keeping uniform weights: bound gain * sqrt(3 / fan_in),
    where a transposed conv of stride s sees 1 / s^2 of its taps."""
    fan = cin * k * k / (stride * stride if transposed else 1)
    bound = gain * math.sqrt(3.0 / fan)
    shape = (cin, cout, k, k) if transposed else (cout, cin, k, k)
    out = [Spec(f"{name}.weight", shape, "range", -bound, bound)]
    if bias:
        out.append(Spec(f"{name}.bias", (cout,), "range", -0.1, 0.1))
    return out


def gdn_specs(name, c) -> List[Spec]:
    return [Spec(f"{name}.beta", (c,), "gdn_beta"), Spec(f"{name}.gamma", (c, c), "gdn_gamma")]


def entropy_parameter_specs(name, cin, m, k, sigma) -> List[Spec]:
    """The last conv's bias puts the scales' raw outputs in ``sigma``, above
    the latents' own scale, so that no latent's bin mass nears the
    likelihood floor or float32's resolution of the normal CDF (where a
    last-bit difference would switch a latent's gradient on or off)."""
    n = m * (1 if k == 1 else k)
    last = conv_specs(f"{name}.Conv2d_2", HIDDEN, (2 if k == 1 else 3) * n, 1, 1.0)
    blocks = ((n, -0.1, 0.1),) * (1 if k == 1 else 2) + ((n, *sigma),)
    bias = Spec(f"{name}.Conv2d_2.bias", last[1].shape, "range", blocks=blocks)
    return (conv_specs(f"{name}.Conv2d_0", cin, HIDDEN, 1, 1.4)
            + conv_specs(f"{name}.Conv2d_1", HIDDEN, HIDDEN, 1, 1.4) + [last[0], bias])


def factorized_specs(name, c) -> List[Spec]:
    full = (1,) + FACTORIZED_FILTERS + (1,)
    layers = len(full) - 1
    scale = 10.0 ** (1.0 / layers)
    out = []
    for i in range(layers):
        o, n = full[i + 1], full[i]
        init = math.log(math.expm1(1.0 / scale / o))
        out.append(Spec(f"{name}.matrix_{i}", (c, o, n), "range", init - 0.2, init + 0.2))
        out.append(Spec(f"{name}.bias_{i}", (c, o, 1), "range", -0.5, 0.5))
        if i < layers - 1:
            out.append(Spec(f"{name}.factor_{i}", (c, o, 1), "range", -0.2, 0.2))
    return out


def draw(specs: List[Spec], generator: torch.Generator, device) -> Params:
    """Every leaf of ``specs`` from one uniform draw of all their elements
    on ``device``: each leaf is its slice, mapped to its range."""
    total = sum(math.prod(s.shape) for s in specs)
    u = torch.rand(total, generator=generator, device=device)
    out, at = {}, 0
    for s in specs:
        n = math.prod(s.shape)
        v = u[at:at + n].view(s.shape)
        at += n
        if s.blocks:
            lo = torch.cat([torch.full((c,), a, device=device) for c, a, _ in s.blocks])
            hi = torch.cat([torch.full((c,), b, device=device) for c, _, b in s.blocks])
            t = lo + (hi - lo) * v
        elif s.init == "range":
            t = s.lo + (s.hi - s.lo) * v
        elif s.init == "gdn_beta":
            t = nonneg_raw(0.5 + v)
        elif s.init == "gdn_gamma":
            c = s.shape[0]
            eye = torch.eye(c, device=device)
            t = nonneg_raw(0.1 * eye + (1.0 - eye) * (0.002 * 128.0 / c) * (0.01 + 0.99 * v))
        else:
            raise ValueError(f"unknown init {s.init!r} for {s.name}")
        out[s.name] = t.contiguous()
    return out
