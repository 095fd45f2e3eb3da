"""Portable (cross-machine) bitstreams for the families' codecs, port of the
JAX package's coding/portable.py (the wavefront, checkerboard and
hyperprior card families, the channel-conditional checkerboard's card set
and the factorized prior's card).

The float codec derives its entropy parameters through float GEMMs whose
results are bit-stable per build only. Here every operation between the
integer latents and the rANS frequency tables is fixed-point arithmetic
with defined rounding, so any two correct implementations (numpy here, C++
in ``csrc/rans/ar_portable.cc``, the JAX package's) write the same bytes on
any hardware.

The deterministic artifact is a ``PortableCard``, built once per model (the
only place floats appear) and shipped with the weights: int16-quantized
weights with per-layer shifts for the hyper-decoder (z_q -> psi), the
masked-context conv and the entropy-parameter net; per-sigma-bin integer
Gaussian CDF tables on a 1/64 sub-grid with raw (pre-softplus) bin
thresholds; an integer exp LUT for the K > 1 mixture softmax; frozen z CDF
tables; and a content hash that every portable stream carries, so a stream
checked against another card fails at once. A card's family says which
coder it drives: 0 the joint-AR wavefront (the 12 causal taps of the masked
context), 1 the checkerboard's two passes (the plain 5x5 context conv's 12
odd-parity taps, ``models.checkerboard.CB_CTX_POSITIONS``), 2 the
hyperprior's one pass (no context: empty ``ctx`` and ``ep1_phi``).
``ChannelCBCards`` drives the channel-conditional checkerboard with one
checkerboard card a channel group, and ``FactorizedCard`` freezes the
factorized prior's tables.

Fixed-point conventions (the cross-implementation spec):
  * activations: F=12 fractional bits, int64 math;
  * weights: per-layer int16 with shift sw; int64 accumulators, requantized
    with rshift_round (round half up, arithmetic shift);
  * leaky-ReLU negative slope 41/4096;
  * mu on a 1/64 sub-grid; sigma snapped to 112 geometric bins over
    [2^-8, 2^6]; mixture weights 16-bit after the LUT softmax;
  * per-symbol alphabet: center c, span R, escape symbol last, every count
    from integer table lookups; total mass exactly 2^32, so frequency
    quantization is an integer shift.

A card's arrays are a function of the model's weights, so a card built by
this package from weights carried over from the JAX package equals the JAX
card, except where the z tables' float PMF rounds a count the other way.
The native coder (``backend.ArPortableCoder``) is the main path; the numpy
functions are its plain version (``native=False``) and write the same bytes.
"""

import hashlib
import math
import struct
from typing import Dict, List, Tuple

import numpy as np

from neural_image_compression_tpu_torch.coding import backend
from neural_image_compression_tpu_torch.models import (
    CB_CTX_POSITIONS, ChannelCheckerboardHierarchical, CheckerboardHierarchical, FactorizedPrior,
    JointAutoregressiveHierarchical, MeanScaleHyperprior, ScalableImageCoding, checkerboard_mask,
)

F_BITS = 12                 # activation fractional bits
SUB_BITS = 6                # mu sub-grid: 1/64
PROB_BITS = 16
PROB_SCALE = 1 << PROB_BITS
W_SCALE = 1 << 16           # mixture weight fixed-point scale
LEAKY_NUM = 41              # leaky slope = 41 / 4096
N_SIGMA_BINS = 112
SIGMA_LOG2_MIN = -8.0
SIGMA_LOG2_MAX = 6.0
EXP_LUT_SIZE = 2048         # exp(-i/128), i in [0, 2048)
EXP_LUT_SHIFT = 5           # F=12 -> 1/128 steps
RANS_L = 1 << 23
# Spec bound on a coded latent's magnitude: keeps the int64 context-GEMM
# accumulators exact (2^24 * 2^F * 2^15 * 12M < 2^63 for M <= M_MAX). Encode
# rejects larger inputs and decode rejects such escapes, in numpy and in C++
# (kYAbsMax).
Y_ABS_MAX = 1 << 24
M_MAX = 330                 # with Y_ABS_MAX: 12*M*2^51 < 2^63 requires M <= 341
# Minimum symbol-window half-span (card version 2), as rans_core.h
# kRMinWindow and ar_portable.cc kPortRMin: an overconfident model's
# mispredicted symbols stay in the window, priced by the freq >= 1 leak,
# instead of taking 32-bit raw escapes.
PORT_R_MIN = 32

_CARD_VERSION = 2           # v2: the PORT_R_MIN window floor (v1 cards raise)
FAMILIES = {"wavefront": 0, "checkerboard": 1, "hyperprior": 2}


def model_family(model) -> str:
    """The portable family of a model: "wavefront" (joint-AR, and each layer
    of the scalable model), "checkerboard" or "hyperprior" (a
    ``PortableCard`` of that family),
    "channel_cb" (a ``ChannelCBCards`` set, ``build_channel_cb_cards``) or
    "factorized" (a ``FactorizedCard``)."""
    for cls, family in ((JointAutoregressiveHierarchical, "wavefront"),
                        (ScalableImageCoding, "wavefront"),
                        (CheckerboardHierarchical, "checkerboard"),
                        (MeanScaleHyperprior, "hyperprior"),
                        (ChannelCheckerboardHierarchical, "channel_cb"),
                        (FactorizedPrior, "factorized")):
        if isinstance(model, cls):
            return family
    raise ValueError(f"no portable card family for {type(model).__name__}")


def rshift_round(v, s: int):
    """Round-half-up arithmetic right shift (numpy int64 or python int)."""
    if s <= 0:
        return v << (-s)
    return (v + (1 << (s - 1))) >> s


# --- weight quantization ------------------------------------------------------

class QuantLayer:
    """One GEMM/conv layer: int16 weights at scale 2^sw, int64 bias at the
    accumulator scale (F_BITS + sw). rshift_round(acc, sw) returns an
    accumulator to F_BITS."""

    def __init__(self, wq: np.ndarray, bq: np.ndarray, sw: int):
        self.wq = wq
        self.bq = bq
        self.sw = sw

    @classmethod
    def quantize(cls, w: np.ndarray, b: np.ndarray) -> "QuantLayer":
        mx = float(np.abs(w).max()) if w.size else 0.0
        sw = 15 if mx == 0 else int(math.floor(math.log2(32767.0 / mx)))
        sw = max(0, min(24, sw))
        wq = np.round(np.asarray(w, np.float64) * (1 << sw)).astype(np.int64)
        if np.abs(wq).max(initial=0) > 32767:
            raise ValueError("weight quantization overflow")
        bq = np.round(np.asarray(b, np.float64) * (1 << (F_BITS + sw))).astype(np.int64)
        return cls(wq.astype(np.int16), bq, sw)


def _imatmul(a: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Exact integer matmul (n, k) @ (k, m) -> int64. Where every partial
    sum (at most k * max|a| * 32767) stays below 2^53, float64 BLAS is exact
    in any summation order; otherwise int64."""
    k = a.shape[-1]
    if a.size and float(np.abs(a).max()) * 32767.0 * k < 2.0 ** 53:
        return (a.astype(np.float64) @ w.astype(np.float64)).astype(np.int64)
    return a.astype(np.int64) @ w.astype(np.int64)


def _gemm(acts: np.ndarray, layer: QuantLayer) -> np.ndarray:
    """(n, k) int64 acts @ (k, m) weights + bias -> int64 accumulator."""
    return _imatmul(acts, layer.wq) + layer.bq


def _requant(acc: np.ndarray, layer: QuantLayer) -> np.ndarray:
    return rshift_round(acc, layer.sw)


def _lrelu(x: np.ndarray) -> np.ndarray:
    return np.where(x >= 0, x, rshift_round(x * LEAKY_NUM, F_BITS))


# --- integer convolution (the hyper-decoder) ----------------------------------

def _int_conv2d(x: np.ndarray, layer: QuantLayer, stride: int, padding: int) -> np.ndarray:
    """x: (H, W, Cin) int64 F_BITS -> (H', W', Cout) int64 F_BITS."""
    kh, kw = layer.wq.shape[:2]
    xp = np.pad(x, ((padding, padding), (padding, padding), (0, 0)))
    oh = (xp.shape[0] - kh) // stride + 1
    ow = (xp.shape[1] - kw) // stride + 1
    acc = np.broadcast_to(layer.bq, (oh, ow, layer.bq.shape[0])).copy()
    for r in range(kh):
        for c in range(kw):
            patch = xp[r:r + oh * stride:stride, c:c + ow * stride:stride, :]
            acc += _imatmul(patch, layer.wq[r, c])
    return rshift_round(acc, layer.sw)


def _int_deconv2d(x: np.ndarray, layer: QuantLayer, stride: int, padding: int,
                  output_padding: int) -> np.ndarray:
    """Transposed conv with the direct-conv kernel (dilate the input, pad
    (k-1-p, k-1-p+op), stride-1 VALID conv), computed per tap over only the
    output rows and columns whose dilated index lands on an input sample:
    the skipped terms are exactly zero, so the int64 sums are the dilated
    form's."""
    kh, kw = layer.wq.shape[:2]
    h, w, _ = x.shape
    hd, wd = (h - 1) * stride + 1, (w - 1) * stride + 1
    lo_r = kh - 1 - padding
    lo_c = kw - 1 - padding  # per-axis pads, so non-square kernels stay exact
    oh = hd + 2 * lo_r + output_padding - kh + 1
    ow = wd + 2 * lo_c + output_padding - kw + 1
    acc = np.broadcast_to(layer.bq, (oh, ow, layer.bq.shape[0])).copy()

    def _span(tap: int, lo: int, out_len: int, in_len: int):
        # output indices oi >= 0 whose dilated index d = oi + tap - lo lies in
        # [0, (in_len-1)*stride] with d % stride == 0 -> input index d//stride
        o0, i0 = lo - tap, 0
        while o0 < 0:
            o0 += stride
            i0 += 1
        if o0 >= out_len or i0 >= in_len:
            return None
        n = min((out_len - 1 - o0) // stride, in_len - 1 - i0) + 1
        return o0, i0, n

    for r in range(kh):
        rs = _span(r, lo_r, oh, h)
        if rs is None:
            continue
        oi0, ii0, nr = rs
        for c in range(kw):
            cs = _span(c, lo_c, ow, w)
            if cs is None:
                continue
            oj0, jj0, nc = cs
            acc[oi0:oi0 + nr * stride:stride, oj0:oj0 + nc * stride:stride] += _imatmul(
                x[ii0:ii0 + nr, jj0:jj0 + nc, :], layer.wq[r, c])
    return rshift_round(acc, layer.sw)


# --- the card -------------------------------------------------------------------

def _inv_softplus(y: float) -> float:
    """x with softplus(x) = y, for y > 0."""
    if y > 30.0:
        return y
    return math.log(math.expm1(y))


def _integer_tables():
    """The model-independent integer Gaussian machinery of every card:
    (sigma_thr, sigma_fix, sigma2_fix, sigma_R, tables, exp_lut): the
    geometric sigma bins with raw-domain thresholds, the per-bin CDF tables
    on the 1/64 sub-grid and the mixture-softmax exp LUT."""
    log2_step = (SIGMA_LOG2_MAX - SIGMA_LOG2_MIN) / (N_SIGMA_BINS - 1)
    sigmas = 2.0 ** (SIGMA_LOG2_MIN + log2_step * np.arange(N_SIGMA_BINS))
    edges = np.sqrt(sigmas[:-1] * sigmas[1:])
    thr = np.array([_inv_softplus(max(e - 1e-6, 1e-12)) for e in edges])
    sigma_thr = np.round(thr * (1 << F_BITS)).astype(np.int64)
    sigma_fix = np.round(sigmas * (1 << F_BITS)).astype(np.int64)
    sigma2_fix = np.round(sigmas ** 2 * (1 << (2 * F_BITS))).astype(np.int64)
    sigma_R = np.clip(np.ceil(6.0 * sigmas) + 2, 2, 254).astype(np.int64)

    try:
        from scipy.special import ndtr as _ndtr
    except ImportError:  # pragma: no cover
        _vec_erf = np.vectorize(math.erf)

        def _ndtr(x):
            return 0.5 * (1.0 + _vec_erf(x / math.sqrt(2.0)))
    tables = []
    for j in range(N_SIGMA_BINS):
        ext = int((sigma_R[j] + 2) << SUB_BITS) + 64
        arg = (np.arange(-ext, ext + 1, dtype=np.float64) / (1 << SUB_BITS)) / sigmas[j]
        tables.append(np.clip(np.round(_ndtr(arg) * PROB_SCALE), 0,
                              PROB_SCALE).astype(np.int32))

    exp_lut = np.round(np.exp(-np.arange(EXP_LUT_SIZE) / 128.0) * W_SCALE).astype(np.int64)
    return sigma_thr, sigma_fix, sigma2_fix, sigma_R, tables, exp_lut


def _hyper_layers(model, params: Dict) -> List[Tuple[str, QuantLayer, Tuple]]:
    """The model's hyper-decoder (its ``transform``: "conv5x5" or "res3x3")
    as a quantized integer layer list, from the flax-layout parameter tree
    (``utils.weights.joint_ar_params_to_jax``: direct-conv HWIO kernels),
    each with its _int_conv2d/_int_deconv2d geometry."""
    hd = params["hyper_decoder"]
    transform = getattr(model, "transform", "conv5x5")
    if transform == "conv5x5":
        seq = [("deconv", hd["Deconv2d_0"], (2, 2, 1)),
               ("deconv", hd["Deconv2d_1"], (2, 2, 1)),
               ("conv", hd["Conv2d_0"], (1, 1))]
    elif transform == "res3x3":
        seq = [("conv", hd["Conv2d_0"], (1, 1)),
               ("deconv", hd["TransposedDeconv3x3_0"]["Deconv2d_0"], (2, 1, 1)),
               ("conv", hd["Conv2d_1"], (1, 1)),
               ("deconv", hd["TransposedDeconv3x3_1"]["Deconv2d_0"], (2, 1, 1)),
               ("conv", hd["Conv2d_2"], (1, 1))]
    else:
        raise ValueError(f"unsupported transform {transform}")
    return [(kind, QuantLayer.quantize(np.asarray(sub["kernel"]), np.asarray(sub["bias"])), geom)
            for kind, sub, geom in seq]


def _quantize_ep1_split(w1: np.ndarray, b1: np.ndarray, phi_dim: int):
    """Quantize the entropy net's layer-1 weight, split at row phi_dim into
    the phi (context) and psi halves, with one shared shift, so the two
    accumulators add at one scale. The layer-1 bias lives in the psi half."""
    ep1_phi = QuantLayer.quantize(w1[:phi_dim], np.zeros(w1.shape[1]))
    ep1_psi = QuantLayer.quantize(w1[phi_dim:], b1)
    sw = min(ep1_phi.sw, ep1_psi.sw) if phi_dim else ep1_psi.sw
    for lay, half, bias in ((ep1_phi, w1[:phi_dim], np.zeros(w1.shape[1])),
                            (ep1_psi, w1[phi_dim:], b1)):
        lay.sw = sw
        lay.wq = np.round(np.asarray(half, np.float64) * (1 << sw)).astype(np.int16)
        lay.bq = np.round(np.asarray(bias, np.float64) * (1 << (F_BITS + sw))).astype(np.int64)
    return ep1_phi, ep1_psi


class PortableCard:
    """Deterministic codec artifact for one model's weights. Build once with
    ``PortableCard.build``; ``save`` and ``load`` carry it. Everything on the
    coding path here is integer; the hash covers every array, so encoder and
    decoder can check they hold the same card."""

    def __init__(self, M: int, K: int, hyper: List[Tuple[str, QuantLayer, Tuple]],
                 ctx: QuantLayer, ep1_phi: QuantLayer, ep1_psi: QuantLayer,
                 ep2: QuantLayer, ep3: QuantLayer,
                 sigma_thr: np.ndarray, sigma_fix: np.ndarray,
                 sigma2_fix: np.ndarray, sigma_R: np.ndarray,
                 tables: List[np.ndarray], exp_lut: np.ndarray,
                 z_cdfs: np.ndarray, z_offsets: np.ndarray,
                 z_sizes: np.ndarray, zmin: int, zmax: int,
                 family: int = FAMILIES["wavefront"]):
        # checked here so build, load and the native coder's fixed buffers
        # (K <= 16 mixture scratch, 2*254+2 symbol edges) all agree
        if not (1 <= K <= 16):
            raise ValueError(f"portable cards support 1 <= K <= 16, got {K}")
        if not (1 <= M <= M_MAX):
            raise ValueError(f"portable cards support 1 <= M <= {M_MAX} (the Y_ABS_MAX "
                             f"context-GEMM exactness bound), got {M}")
        if sigma_R.size and not (0 <= int(sigma_R.min()) and int(sigma_R.max()) <= 254):
            raise ValueError("corrupt card: sigma_R outside [0, 254]")
        if family not in FAMILIES.values():
            raise ValueError(f"unknown card family {family}")
        self.M = M
        self.K = K
        self.family = family
        self.hyper = hyper          # [(kind, layer, geometry), ...]
        self.ctx = ctx
        self.ep1_phi = ep1_phi
        self.ep1_psi = ep1_psi      # holds the bias of the entropy net's layer 1
        self.ep2 = ep2
        self.ep3 = ep3
        self.sigma_thr = sigma_thr  # (NB-1,) int64 raw-domain thresholds, F_BITS
        self.sigma_fix = sigma_fix  # (NB,) int64 sigma at F_BITS
        self.sigma2_fix = sigma2_fix  # (NB,) int64 sigma^2 at 2*F_BITS
        self.sigma_R = sigma_R      # (NB,) int64 per-bin span
        self.tables = tables        # per bin: (len,) int32 CDF, centered
        self.exp_lut = exp_lut      # (EXP_LUT_SIZE,) int64 at 2^16
        self.z_cdfs = z_cdfs
        self.z_offsets = z_offsets
        self.z_sizes = z_sizes
        self.zmin = zmin
        self.zmax = zmax
        self.hash = self._compute_hash()
        self._native = None

    # -- hashing and serialization -------------------------------------------
    def _arrays(self) -> List[Tuple[str, np.ndarray]]:
        out = [("meta", np.array([_CARD_VERSION, self.M, self.K, self.zmin, self.zmax,
                                  self.family], np.int64))]
        for i, (kind, layer, geom) in enumerate(self.hyper):
            out.append((f"hyper{i}_w", layer.wq))
            out.append((f"hyper{i}_b", layer.bq))
            out.append((f"hyper{i}_g", np.array(
                [{"conv": 0, "deconv": 1}[kind], layer.sw, *geom], np.int64)))
        for name in ("ctx", "ep1_phi", "ep1_psi", "ep2", "ep3"):
            layer = getattr(self, name)
            out.append((f"{name}_w", layer.wq))
            out.append((f"{name}_b", layer.bq))
            out.append((f"{name}_s", np.array([layer.sw], np.int64)))
        out += [("sigma_thr", self.sigma_thr), ("sigma_fix", self.sigma_fix),
                ("sigma2_fix", self.sigma2_fix), ("sigma_R", self.sigma_R),
                ("exp_lut", self.exp_lut), ("z_cdfs", self.z_cdfs),
                ("z_offsets", self.z_offsets), ("z_sizes", self.z_sizes)]
        for j, t in enumerate(self.tables):
            out.append((f"table{j}", t))
        return out

    def _compute_hash(self) -> bytes:
        h = hashlib.sha256()
        for name, arr in self._arrays():
            h.update(name.encode())
            h.update(str(arr.dtype).encode())
            h.update(str(arr.shape).encode())
            h.update(np.ascontiguousarray(arr).tobytes())
        return h.digest()[:8]

    def save(self, path: str) -> None:
        np.savez_compressed(path, **dict(self._arrays()))

    @classmethod
    def load(cls, path: str) -> "PortableCard":
        with np.load(path) as d:
            return cls._from_mapping(d)

    @classmethod
    def _from_mapping(cls, d) -> "PortableCard":
        """Rebuild from a mapping (``in`` and ``[]``) over the _arrays() keys."""
        meta = d["meta"]
        version, M, K, zmin, zmax = (int(v) for v in meta[:5])
        family = int(meta[5]) if len(meta) > 5 else FAMILIES["wavefront"]
        if version != _CARD_VERSION:
            raise ValueError(f"unsupported card version {version}")
        hyper = []
        i = 0
        while f"hyper{i}_w" in d:
            g = d[f"hyper{i}_g"]
            kind = "conv" if g[0] == 0 else "deconv"
            layer = QuantLayer(d[f"hyper{i}_w"], d[f"hyper{i}_b"], int(g[1]))
            hyper.append((kind, layer, tuple(int(v) for v in g[2:])))
            i += 1
        layers = {name: QuantLayer(d[f"{name}_w"], d[f"{name}_b"], int(d[f"{name}_s"][0]))
                  for name in ("ctx", "ep1_phi", "ep1_psi", "ep2", "ep3")}
        tables = []
        j = 0
        while f"table{j}" in d:
            tables.append(d[f"table{j}"])
            j += 1
        return cls(M, K, hyper, layers["ctx"], layers["ep1_phi"], layers["ep1_psi"],
                   layers["ep2"], layers["ep3"], d["sigma_thr"], d["sigma_fix"],
                   d["sigma2_fix"], d["sigma_R"], tables, d["exp_lut"], d["z_cdfs"],
                   d["z_offsets"], d["z_sizes"], zmin, zmax, family)

    # -- build -----------------------------------------------------------------
    @classmethod
    def build(cls, model, zmin: int = -64, zmax: int = 64, family: str = None,
              ctx_name: str = "context_model", ep_name: str = "entropy_parameters",
              M: int = None, K: int = None) -> "PortableCard":
        """Quantize a hierarchical model's coding-path weights and
        precompute every integer table: the only float computation of
        portable mode. family: "wavefront", "checkerboard" or "hyperprior"
        (default: the model's own, ``model_family``). ctx_name, ep_name, M
        and K pick the context and entropy-parameter pair the card covers
        and its widths (default: the model's one pair at its own M and K);
        the scalable model builds one card a layer (``context_model_1`` and
        ``entropy_parameters_1`` at M1, the ``_2`` pair at M - M1), each with
        the shared hyper-decoder and z tables. The hyper-decoder's kernels
        are quantized in the flax layout, the context (its 12 live taps) and
        entropy nets in the native coder's layout (``codec._HostParamNets``),
        and the z tables come from ``cdf_tables.factorized_tables`` on the
        model's device."""
        from neural_image_compression_tpu_torch.coding.cdf_tables import factorized_tables
        from neural_image_compression_tpu_torch.coding.codec import _HostParamNets
        from neural_image_compression_tpu_torch.utils.weights import joint_ar_params_to_jax

        family = family or model_family(model)
        if family not in FAMILIES:
            raise ValueError(f"a {family} model takes "
                             + ("a ChannelCBCards set (build_channel_cb_cards)"
                                if family == "channel_cb" else "a FactorizedCard"))
        M = model.latent_channels if M is None else M
        K = model.K if K is None else K
        nets = _HostParamNets(model, family, ctx_name, ep_name, M)
        hyper = _hyper_layers(model, joint_ar_params_to_jax(model))
        ctx = QuantLayer.quantize(nets.ctx_w, nets.ctx_bias)
        (w1, b1), (w2, b2), (w3, b3) = nets.ep
        ep1_phi, ep1_psi = _quantize_ep1_split(w1, b1, nets.ctx_w.shape[1])
        ep2 = QuantLayer.quantize(w2, b2)
        ep3 = QuantLayer.quantize(w3, b3)
        sigma_thr, sigma_fix, sigma2_fix, sigma_R, tables, exp_lut = _integer_tables()
        z_cdfs, z_offsets, z_sizes = factorized_tables(model, zmin, zmax)
        return cls(M, K, hyper, ctx, ep1_phi, ep1_psi, ep2, ep3,
                   sigma_thr, sigma_fix, sigma2_fix, sigma_R, tables, exp_lut,
                   z_cdfs.astype(np.uint32), np.asarray(z_offsets, np.int32),
                   np.asarray(z_sizes, np.int32), zmin, zmax, FAMILIES[family])

    def native_coder(self) -> backend.ArPortableCoder:
        """The C++ coder over this card (built at first use)."""
        if self._native is None:
            self._native = backend.ArPortableCoder(self)
        return self._native

    # -- integer forward passes -------------------------------------------------
    def hyper_forward(self, z_q: np.ndarray, native: bool = True) -> np.ndarray:
        """z_q: (hz, wz, M) integer-valued -> psi (h, w, 2M) int64 at F_BITS.
        Exact integer arithmetic on both paths (order-free sums): the native
        coder and the numpy version give the same values."""
        if native:
            return self.native_coder().hyper(np.asarray(z_q))
        x = np.asarray(z_q).astype(np.int64) << F_BITS
        for i, (kind, layer, geom) in enumerate(self.hyper):
            x = _int_conv2d(x, layer, *geom) if kind == "conv" else _int_deconv2d(x, layer, *geom)
            if i < len(self.hyper) - 1:
                x = _lrelu(x)
        return x

    def psi_precompute(self, psi_fix: np.ndarray, native: bool = True) -> np.ndarray:
        """(h, w, 2M) psi -> (h*w, hidden) int64 accumulators: the layer-1
        psi half plus the bias, not yet requantized. Exact on both paths."""
        flat = psi_fix.reshape(-1, psi_fix.shape[-1])
        if native:
            return self.native_coder().psi(flat)
        return _gemm(flat, self.ep1_psi)

    def wave_params(self, gathered: np.ndarray, p_acc: np.ndarray) -> np.ndarray:
        """gathered: (n, 12M) int64 latent context at F_BITS; p_acc: (n,
        hidden) layer-1 psi accumulators -> raw h3 (n, out_dim) int64 at
        F_BITS, columns in the coder's (kind, m, k) order."""
        phi = _requant(_gemm(gathered, self.ctx), self.ctx)
        return self.params_from_acc(_imatmul(phi, self.ep1_phi.wq) + p_acc)

    def params_from_acc(self, acc1: np.ndarray) -> np.ndarray:
        """Layer-1 accumulators -> raw h3."""
        h = _lrelu(rshift_round(acc1, self.ep1_phi.sw))
        h = _lrelu(_requant(_gemm(h, self.ep2), self.ep2))
        return _requant(_gemm(h, self.ep3), self.ep3)

    def channel_models(self, h3_row: np.ndarray):
        """One pixel's raw entropy-net output -> (mu_fix (M, K), bins (M, K),
        wfix (M, K)) int64, the mixture weights fixed-point (summing to 2^16
        exactly)."""
        M, K = self.M, self.K
        if K == 1:
            mu = h3_row[:M].reshape(M, 1)
            sraw = h3_row[M:].reshape(M, 1)
            bins = np.searchsorted(self.sigma_thr, sraw.reshape(-1), side="right").reshape(M, 1)
            wfix = np.full((M, 1), W_SCALE, np.int64)
            return mu, bins.astype(np.int64), wfix
        MK = M * K
        # coder layout (kind, m, k): _HostParamNets permutes the last layer's
        # columns, and the card quantizes those weights
        a = h3_row[:MK].reshape(M, K)                    # (M, K) logits
        mu = h3_row[MK:2 * MK].reshape(M, K).copy()
        sraw = h3_row[2 * MK:].reshape(M, K)
        bins = np.searchsorted(self.sigma_thr, sraw.reshape(-1),
                               side="right").reshape(M, K).astype(np.int64)
        d = a.max(axis=1, keepdims=True) - a              # >= 0
        idx = np.minimum(rshift_round(d, EXP_LUT_SHIFT), EXP_LUT_SIZE - 1)
        e = self.exp_lut[idx]                             # (M, K)
        s = e.sum(axis=1, keepdims=True)
        wfix = (e << 16) // s
        rem = W_SCALE - wfix.sum(axis=1)
        am = e.argmax(axis=1)                             # first max
        wfix[np.arange(M), am] += rem
        return mu, bins, wfix


# --- per-symbol model construction (the integer spec) ----------------------------

def build_symbol_model(card: PortableCard, mu_fix: np.ndarray, bins: np.ndarray,
                       wfix: np.ndarray):
    """One channel's K components -> (c, R, cum), cum uint32 summing to
    2^16. Pure integer: the cross-implementation contract."""
    K = mu_fix.shape[0]
    if K == 1:
        c = int(rshift_round(int(mu_fix[0]), F_BITS))
        R = max(PORT_R_MIN, int(card.sigma_R[int(bins[0])]))
    else:
        mean_acc = int((wfix * mu_fix).sum())
        mean_fix = rshift_round(mean_acc, 16)                     # F_BITS
        m2_acc = int((wfix * (card.sigma2_fix[bins] + mu_fix * mu_fix)).sum())
        m2_fix = rshift_round(m2_acc, 16)                         # 2F
        var_fix = m2_fix - mean_fix * mean_fix
        if var_fix < 1:
            var_fix = 1
        std_fix = math.isqrt(int(var_fix))                        # F_BITS
        c = int(rshift_round(mean_fix, F_BITS))
        R = (6 * std_fix + (1 << F_BITS) - 1) >> F_BITS
        R = min(254, max(PORT_R_MIN, R + 2))
    nsym = 2 * R + 2

    e_idx = np.arange(nsym, dtype=np.int64)
    edge_acc = np.zeros(nsym, np.int64)
    base = -((R << SUB_BITS) + 32)
    for k in range(K):
        mu_idx = rshift_round(int(mu_fix[k]), F_BITS - SUB_BITS)
        mu_sub = mu_idx - (c << SUB_BITS)
        tab = card.tables[int(bins[k])]
        ext = (len(tab) - 1) // 2
        arg = base + (e_idx << SUB_BITS) - mu_sub + ext
        vals = tab[np.clip(arg, 0, len(tab) - 1)]
        edge_acc += int(wfix[k]) * vals.astype(np.int64)
    pmf = np.maximum(np.diff(edge_acc), 0)
    esc = int(edge_acc[0]) + ((int(wfix.sum()) << PROB_BITS) - int(edge_acc[-1]))
    if esc < 0:
        esc = 0
    pmf_full = np.concatenate([pmf, [esc]])
    budget = PROB_SCALE - nsym
    freq = 1 + ((pmf_full * budget) >> 32)
    rem = PROB_SCALE - int(freq.sum())
    am = int(pmf_full.argmax())                                    # first max
    freq[am] += rem
    cum = np.zeros(nsym + 1, np.uint32)
    cum[1:] = np.cumsum(freq).astype(np.uint32)
    return c, R, cum


# --- pure-python rANS (a mirror of rans_core.h) ------------------------------------

class PyEncoder:
    def __init__(self):
        self.x = RANS_L
        self.bytes = bytearray()

    def put(self, cum: int, freq: int) -> None:
        x_max = ((RANS_L >> PROB_BITS) << 8) * freq
        while self.x >= x_max:
            self.bytes.append(self.x & 0xFF)
            self.x >>= 8
        self.x = ((self.x // freq) << PROB_BITS) + (self.x % freq) + cum

    def put_raw16(self, v: int) -> None:
        self.put(v, 1)

    def flush(self) -> bytes:
        for shift in (0, 8, 16, 24):
            self.bytes.append((self.x >> shift) & 0xFF)
        return bytes(reversed(self.bytes))


class PyDecoder:
    def __init__(self, data: bytes):
        self.buf = data
        self.len = len(data)
        self.pos = 0
        self.x = 0
        for _ in range(min(4, self.len)):
            self.x = ((self.x << 8) | self.buf[self.pos]) & 0xFFFFFFFF
            self.pos += 1

    def peek(self) -> int:
        return self.x & (PROB_SCALE - 1)

    def advance(self, cum: int, freq: int) -> None:
        self.x = freq * (self.x >> PROB_BITS) + (self.x & (PROB_SCALE - 1)) - cum
        while self.x < RANS_L and self.pos < self.len:
            self.x = (self.x << 8) | self.buf[self.pos]
            self.pos += 1

    def get_raw16(self) -> int:
        v = self.peek()
        self.advance(v, 1)
        return v

    def ok(self) -> bool:
        return self.x == RANS_L and self.pos == self.len


def _cdf_find(cum: np.ndarray, cf: int) -> int:
    # cum is strictly increasing: the j with cum[j] <= cf < cum[j+1]
    return int(np.searchsorted(cum, cf, side="right")) - 1


# --- wavefront encode and decode --------------------------------------------------

def wavefront_order(h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """(pix (h*w, 2) int32 in decode order, wave sizes): wave t = 3i + j."""
    waves: Dict[int, list] = {}
    for i in range(h):
        for j in range(w):
            waves.setdefault(3 * i + j, []).append((i, j))
    order, sizes = [], []
    for t in sorted(waves):
        order.extend(waves[t])
        sizes.append(len(waves[t]))
    return np.asarray(order, np.int32), np.asarray(sizes, np.int32)


def _gather(y_pad: np.ndarray, pix: np.ndarray, positions) -> np.ndarray:
    """y_pad: (h+4, w+4, M) int64 F_BITS; pix (n, 2) -> (n, 12M), the taps
    at ``positions`` (kernel coordinates, center (2, 2)) in that order."""
    n = pix.shape[0]
    m = y_pad.shape[-1]
    out = np.empty((n, 12 * m), np.int64)
    for idx, (r, c) in enumerate(positions):
        out[:, idx * m:(idx + 1) * m] = y_pad[pix[:, 0] + r, pix[:, 1] + c]
    return out


def _gather_context(y_pad: np.ndarray, pix: np.ndarray) -> np.ndarray:
    """The mask-A gather (``codec.CTX_POSITIONS``)."""
    from neural_image_compression_tpu_torch.coding.codec import CTX_POSITIONS

    return _gather(y_pad, pix, CTX_POSITIONS)


def _cb_gather(y_pad: np.ndarray, pix: np.ndarray) -> np.ndarray:
    """y_pad holding the anchors only (zeros at the non-anchors); pix the
    non-anchors -> their 12 anchor taps in ``CB_CTX_POSITIONS`` order."""
    return _gather(y_pad, pix, CB_CTX_POSITIONS)


def _check_family(card: PortableCard, family: str) -> None:
    if card.family != FAMILIES[family]:
        raise ValueError(f"card is not a {family}-family card (family {FAMILIES[family]}); "
                         f"it has family {card.family}")


def _check_magnitude(y_q: np.ndarray) -> None:
    if not (np.abs(np.asarray(y_q)).max(initial=0) <= Y_ABS_MAX):
        # `not (.. <= ..)` so NaN fails too
        raise ValueError(f"latent magnitude exceeds the portable-spec bound "
                         f"(|y| <= {Y_ABS_MAX}) or is non-finite")


def _symbol_models(card: PortableCard, h3: np.ndarray, y_rows: np.ndarray, syms: list,
                   models: list) -> None:
    """Append each pixel's M symbols and their (mu, bin, weight) models, in
    channel order, for the pixels' raw h3 rows and latent rows."""
    for p in range(h3.shape[0]):
        mu, bins, wfix = card.channel_models(h3[p])
        for m in range(card.M):
            syms.append(int(y_rows[p, m]))
            models.append((mu[m], bins[m], wfix[m]))


def _py_rans_encode(card: PortableCard, syms: list, models: list) -> bytes:
    """The numpy spec's rANS encode of symbols under their models (in
    reverse, escapes as two raw 16-bit halves)."""
    enc = PyEncoder()
    for i in range(len(syms) - 1, -1, -1):
        c, R, cum = build_symbol_model(card, *models[i])
        d = syms[i] - c
        if -R <= d <= R:
            j = d + R
        else:
            v = (syms[i] + 0x80000000) & 0xFFFFFFFF
            enc.put_raw16(v & 0xFFFF)
            enc.put_raw16((v >> 16) & 0xFFFF)
            j = 2 * R + 1
        enc.put(int(cum[j]), int(cum[j + 1] - cum[j]))
    return enc.flush()


def _py_decode_pixel(card: PortableCard, dec: "PyDecoder", h3_row: np.ndarray) -> np.ndarray:
    """One pixel's M symbols (int64) from the decoder, under its h3 row."""
    mu, bins, wfix = card.channel_models(h3_row)
    out = np.empty(card.M, np.int64)
    for m in range(card.M):
        c, R, cum = build_symbol_model(card, mu[m], bins[m], wfix[m])
        jj = _cdf_find(cum, dec.peek())
        dec.advance(int(cum[jj]), int(cum[jj + 1] - cum[jj]))
        if jj == 2 * R + 1:
            hi = dec.get_raw16()
            lo = dec.get_raw16()
            v = ((hi << 16) | lo) - 0x80000000
            if abs(v) > Y_ABS_MAX:  # as kYAbsMax in C++
                raise ValueError("corrupt portable AR stream (escape out of spec)")
        else:
            v = c + (jj - R)
        out[m] = v
    return out


def _py_finish(dec: "PyDecoder") -> None:
    if not dec.ok():
        raise ValueError("corrupt or truncated portable AR stream")


# --- wavefront (family 0) --------------------------------------------------------

def portable_ar_encode(card: PortableCard, y_q: np.ndarray, psi_fix: np.ndarray,
                       native: bool = True) -> bytes:
    """Encode one latent layer on the integer parameter path (a
    wavefront-family card). y_q: (h, w, M) integer-valued; psi_fix: (h, w,
    2M) int64 at F_BITS. native selects the C++ coder (True) or the numpy
    version (False): both write the same bytes."""
    _check_family(card, "wavefront")
    _check_magnitude(y_q)
    if native:
        p_acc = card.psi_precompute(psi_fix, native=True)
        return card.native_coder().encode(np.asarray(y_q).astype(np.int32), p_acc)
    return _py_ar_encode(card, y_q, psi_fix)


def _py_ar_encode(card: PortableCard, y_q: np.ndarray, psi_fix: np.ndarray) -> bytes:
    h, w = y_q.shape[:2]
    y_int = np.asarray(y_q).astype(np.int64)
    pix, wave_sizes = wavefront_order(h, w)
    p_acc = card.psi_precompute(psi_fix, native=False).reshape(h * w, -1)
    y_pad = np.zeros((h + 4, w + 4, card.M), np.int64)
    y_pad[2:-2, 2:-2] = y_int << F_BITS

    syms: List[int] = []
    models: List[Tuple] = []
    start = 0
    for ws in wave_sizes:
        wp = pix[start:start + ws]
        start += ws
        h3 = card.wave_params(_gather_context(y_pad, wp), p_acc[wp[:, 0] * w + wp[:, 1]])
        _symbol_models(card, h3, y_int[wp[:, 0], wp[:, 1]], syms, models)
    return _py_rans_encode(card, syms, models)


def portable_ar_decode(card: PortableCard, data: bytes, psi_fix: np.ndarray,
                       h: int, w: int, native: bool = True) -> np.ndarray:
    """Decode one latent layer -> (h, w, M) float32 integers."""
    _check_family(card, "wavefront")
    if native:
        p_acc = card.psi_precompute(psi_fix, native=True)
        return card.native_coder().decode(data, p_acc, h, w)
    return _py_ar_decode(card, data, psi_fix, h, w)


def _py_ar_decode(card: PortableCard, data: bytes, psi_fix: np.ndarray,
                  h: int, w: int) -> np.ndarray:
    pix, wave_sizes = wavefront_order(h, w)
    p_acc = card.psi_precompute(psi_fix, native=False).reshape(h * w, -1)
    y_pad = np.zeros((h + 4, w + 4, card.M), np.int64)
    y_out = np.zeros((h, w, card.M), np.int64)
    dec = PyDecoder(data)
    start = 0
    for ws in wave_sizes:
        wp = pix[start:start + ws]
        start += ws
        h3 = card.wave_params(_gather_context(y_pad, wp), p_acc[wp[:, 0] * w + wp[:, 1]])
        for p in range(ws):
            i, j = int(wp[p, 0]), int(wp[p, 1])
            y_out[i, j] = _py_decode_pixel(card, dec, h3[p])
            y_pad[i + 2, j + 2] = y_out[i, j] << F_BITS
    _py_finish(dec)
    return y_out.astype(np.float32)


# --- checkerboard (family 1): anchors from psi alone, then non-anchors --------------

def _cb_plan(h: int, w: int):
    """(anchor mask, anchor pix, non-anchor pix), row-major within each
    block: the stream's symbol order (the float CheckerboardCodec's
    y_q[am] then y_q[~am])."""
    am = checkerboard_mask(h, w)
    return am, np.argwhere(am).astype(np.int64), np.argwhere(~am).astype(np.int64)


def _cb_pass_params(card: PortableCard, p_acc: np.ndarray, w: int, pix: np.ndarray,
                    y_pad=None) -> np.ndarray:
    """h3 rows of one pass: the anchors (y_pad None: the context is exactly
    zero) or the non-anchors (the context GEMM over their anchor taps)."""
    rows = p_acc[pix[:, 0] * w + pix[:, 1]]
    if y_pad is None:
        return card.params_from_acc(rows)
    return card.wave_params(_cb_gather(y_pad, pix), rows)


def portable_cb_encode(card: PortableCard, y_q: np.ndarray, psi_fix: np.ndarray,
                       native: bool = True) -> bytes:
    """Encode one checkerboard latent grid on the integer parameter path (a
    checkerboard-family card): the anchors from the hyperprior alone, then
    the non-anchors from the 12-tap context over the anchors. Arguments as
    ``portable_ar_encode``'s; both paths write the same bytes."""
    _check_family(card, "checkerboard")
    _check_magnitude(y_q)
    if native:
        p_acc = card.psi_precompute(psi_fix, native=True)
        return card.native_coder().encode_cb(np.asarray(y_q).astype(np.int32), p_acc)
    return _py_cb_encode(card, y_q, psi_fix)


def _py_cb_encode(card: PortableCard, y_q: np.ndarray, psi_fix: np.ndarray) -> bytes:
    h, w = y_q.shape[:2]
    y_int = np.asarray(y_q).astype(np.int64)
    am, pix_a, pix_n = _cb_plan(h, w)
    p_acc = card.psi_precompute(psi_fix, native=False).reshape(h * w, -1)
    y_pad = np.zeros((h + 4, w + 4, card.M), np.int64)
    y_pad[2:-2, 2:-2][am] = y_int[am] << F_BITS  # the anchors only, as decode sees them
    syms: List[int] = []
    models: List[Tuple] = []
    for pix, pad in ((pix_a, None), (pix_n, y_pad)):
        _symbol_models(card, _cb_pass_params(card, p_acc, w, pix, pad),
                       y_int[pix[:, 0], pix[:, 1]], syms, models)
    return _py_rans_encode(card, syms, models)


def portable_cb_decode(card: PortableCard, data: bytes, psi_fix: np.ndarray,
                       h: int, w: int, native: bool = True) -> np.ndarray:
    """Decode one checkerboard latent grid -> (h, w, M) float32 integers."""
    _check_family(card, "checkerboard")
    if native:
        p_acc = card.psi_precompute(psi_fix, native=True)
        return card.native_coder().decode_cb(data, p_acc, h, w)
    return _py_cb_decode(card, data, psi_fix, h, w)


def _py_cb_decode(card: PortableCard, data: bytes, psi_fix: np.ndarray,
                  h: int, w: int) -> np.ndarray:
    _, pix_a, pix_n = _cb_plan(h, w)
    p_acc = card.psi_precompute(psi_fix, native=False).reshape(h * w, -1)
    y_out = np.zeros((h, w, card.M), np.int64)
    y_pad = np.zeros((h + 4, w + 4, card.M), np.int64)
    dec = PyDecoder(data)
    h3 = _cb_pass_params(card, p_acc, w, pix_a)
    for p, (i, j) in enumerate(pix_a):
        y_out[i, j] = _py_decode_pixel(card, dec, h3[p])
        y_pad[i + 2, j + 2] = y_out[i, j] << F_BITS
    h3 = _cb_pass_params(card, p_acc, w, pix_n, y_pad)
    for p, (i, j) in enumerate(pix_n):
        y_out[i, j] = _py_decode_pixel(card, dec, h3[p])
    _py_finish(dec)
    return y_out.astype(np.float32)


# --- hyperprior (family 2): every position from psi alone ---------------------------

def portable_hp_encode(card: PortableCard, y_q: np.ndarray, psi_fix: np.ndarray,
                       native: bool = True) -> bytes:
    """Encode one hyperprior latent grid on the integer parameter path (a
    hyperprior-family card): every position's parameters from psi alone,
    row-major, channel fastest (the float MeanScaleHyperpriorCodec's symbol
    order). Arguments as ``portable_ar_encode``'s."""
    _check_family(card, "hyperprior")
    _check_magnitude(y_q)
    if native:
        p_acc = card.psi_precompute(psi_fix, native=True)
        return card.native_coder().encode_hp(np.asarray(y_q).astype(np.int32), p_acc)
    return _py_hp_encode(card, y_q, psi_fix)


def _py_hp_encode(card: PortableCard, y_q: np.ndarray, psi_fix: np.ndarray) -> bytes:
    h, w = y_q.shape[:2]
    p_acc = card.psi_precompute(psi_fix, native=False).reshape(h * w, -1)
    syms: List[int] = []
    models: List[Tuple] = []
    _symbol_models(card, card.params_from_acc(p_acc),
                   np.asarray(y_q).astype(np.int64).reshape(h * w, card.M), syms, models)
    return _py_rans_encode(card, syms, models)


def portable_hp_decode(card: PortableCard, data: bytes, psi_fix: np.ndarray,
                       h: int, w: int, native: bool = True) -> np.ndarray:
    """Decode one hyperprior latent grid -> (h, w, M) float32 integers."""
    _check_family(card, "hyperprior")
    if native:
        p_acc = card.psi_precompute(psi_fix, native=True)
        return card.native_coder().decode_hp(data, p_acc, h, w)
    return _py_hp_decode(card, data, psi_fix, h, w)


def _py_hp_decode(card: PortableCard, data: bytes, psi_fix: np.ndarray,
                  h: int, w: int) -> np.ndarray:
    p_acc = card.psi_precompute(psi_fix, native=False).reshape(h * w, -1)
    h3 = card.params_from_acc(p_acc)
    dec = PyDecoder(data)
    y_out = np.stack([_py_decode_pixel(card, dec, h3[p]) for p in range(h * w)])
    _py_finish(dec)
    return y_out.reshape(h, w, card.M).astype(np.float32)


# --- the channel-conditional checkerboard's card set: one checkerboard card a group ----

class ChannelCBCards:
    """Portable card set of the channel-conditional checkerboard
    (``models.ChannelCheckerboardHierarchical``): one checkerboard-family
    card a channel group, coded group by group with the two-pass integer
    coder.

    Group i's entropy parameters depend on [spatial context, channel
    context, psi]. The spatial context is the group's 12 odd-parity 5x5
    taps, a checkerboard card's context GEMM; the channel context is two
    dense stride-1 convs over the decoded groups, an integer conv stack like
    the hyper-decoder's. So sub-card i is a family-1 ``PortableCard`` whose
    ``hyper`` slot holds the group's channel-context convs (group 0's holds
    the z hyper-decoder) and whose per-position "psi" row is [channel
    context || psi] (group 0: psi alone; its channel rows see exact zeros,
    which add nothing to the integer accumulators, so the card drops them).
    Every group then codes through ``portable_cb_encode`` /
    ``portable_cb_decode``. The hash covers the groups and every sub-card's
    hash."""

    def __init__(self, cards: List[PortableCard], groups):
        groups = tuple(int(g) for g in groups)
        if not cards or len(cards) != len(groups):
            raise ValueError("card/group count mismatch")
        for c, g in zip(cards, groups):
            if c.family != FAMILIES["checkerboard"] or c.M != g:
                raise ValueError("corrupt channel_cb card set: sub-card family/width does not "
                                 "match its group")
        self.cards = tuple(cards)
        self.groups = groups
        self.M = sum(groups)
        self.K = cards[0].K
        self.zmin, self.zmax = cards[0].zmin, cards[0].zmax
        self.z_cdfs = cards[0].z_cdfs
        self.z_offsets = cards[0].z_offsets
        self.z_sizes = cards[0].z_sizes
        h = hashlib.sha256()
        h.update(np.asarray(groups, np.int64).tobytes())
        for c in cards:
            h.update(c.hash)
        self.hash = h.digest()[:8]

    def hyper_forward(self, z_q: np.ndarray, native: bool = True) -> np.ndarray:
        """psi from z_q: group 0's sub-card holds the z hyper-decoder."""
        return self.cards[0].hyper_forward(z_q, native=native)

    def channel_forward(self, i: int, y_prev: np.ndarray, native: bool = True) -> np.ndarray:
        """Group i's (> 0) integer channel context from the decoded groups
        before it, y_prev (h, w, sum(groups[:i])) integer-valued: sub-card
        i's ``hyper`` slot holds the two dense 5x5 convs."""
        return self.cards[i].hyper_forward(y_prev, native=native)

    def save(self, path: str) -> None:
        arrs = {"groups": np.asarray(self.groups, np.int64)}
        for i, card in enumerate(self.cards):
            arrs.update({f"g{i}_{k}": v for k, v in card._arrays()})
        np.savez_compressed(path, **arrs)

    @classmethod
    def load(cls, path: str) -> "ChannelCBCards":
        with np.load(path) as d:
            if "groups" not in d:
                raise ValueError(f"{path} is not a channel_cb card set (no groups array)")
            groups = tuple(int(g) for g in d["groups"])
            cards = []
            for i in range(len(groups)):
                sub = {k[len(f"g{i}_"):]: d[k] for k in d.files if k.startswith(f"g{i}_")}
                if not sub:
                    raise ValueError(f"{path} is missing sub-card g{i}")
                cards.append(PortableCard._from_mapping(sub))
        return cls(cards, groups)


def build_channel_cb_cards(model, zmin: int = -64, zmax: int = 64) -> ChannelCBCards:
    """Quantize a ChannelCheckerboardHierarchical's coding-path weights into
    a ``ChannelCBCards`` set: the only float computation of its portable
    mode. Per group i: ``spatial_ctx_i`` (its 12 odd-parity taps),
    ``channel_ctx_i`` (conv 5x5, leaky ReLU, conv 5x5; i > 0) and
    ``entropy_parameters_i`` (the 1x1 net over [spatial (2g) | channel (2g)
    | psi (2M)]), in the layouts ``PortableCard.build`` uses; the z tables
    as there."""
    from neural_image_compression_tpu_torch.coding.cdf_tables import factorized_tables
    from neural_image_compression_tpu_torch.coding.codec import _HostParamNets
    from neural_image_compression_tpu_torch.utils.weights import joint_ar_params_to_jax

    params = joint_ar_params_to_jax(model)
    K, groups = model.K, tuple(model.group_sizes)
    sigma_thr, sigma_fix, sigma2_fix, sigma_R, tables, exp_lut = _integer_tables()
    z_cdfs, z_offsets, z_sizes = factorized_tables(model, zmin, zmax)
    z_tables = (z_cdfs.astype(np.uint32), np.asarray(z_offsets, np.int32),
                np.asarray(z_sizes, np.int32))
    cards = []
    off = 0
    for i, gi in enumerate(groups):
        nets = _HostParamNets.ep_only(getattr(model, f"entropy_parameters_{i}"), gi, K)
        ctx = QuantLayer.quantize(*_HostParamNets.context_taps(getattr(model, f"spatial_ctx_{i}"),
                                                              CB_CTX_POSITIONS))
        (w1, b1), (w2, b2), (w3, b3) = nets.ep
        # layer-1 rows: [0, 2g) spatial, [2g, 4g) channel, [4g, ...) psi; group
        # 0 has no channel context, so its psi half is the psi rows alone
        psi_lo = 2 * gi if i > 0 else 4 * gi
        ep1_phi, ep1_psi = _quantize_ep1_split(np.vstack([w1[:2 * gi], w1[psi_lo:]]), b1,
                                               2 * gi)
        if i == 0:
            hyper = _hyper_layers(model, params)
        else:
            # the first conv's exactness bound, as the context GEMM's
            # Y_ABS_MAX argument: 25 taps x `off` channels of (|y| << F) * w
            # int64 terms must stay below 2^63
            if 25 * off * (Y_ABS_MAX << F_BITS) * 32767 >= 2 ** 63:
                raise ValueError(f"channel-context conv over {off} decoded channels exceeds "
                                 f"the int64 exactness bound: reduce the prefix groups' widths "
                                 f"(sum(groups[:-1]) <= 163)")
            ch = params[f"channel_ctx_{i}"]
            hyper = [("conv", QuantLayer.quantize(np.asarray(ch[name]["kernel"]),
                                                  np.asarray(ch[name]["bias"])), (1, 2))
                     for name in ("Conv2d_0", "Conv2d_1")]
        cards.append(PortableCard(
            gi, K, hyper, ctx, ep1_phi, ep1_psi, QuantLayer.quantize(w2, b2),
            QuantLayer.quantize(w3, b3), sigma_thr, sigma_fix, sigma2_fix, sigma_R, tables,
            exp_lut, *z_tables, zmin, zmax, FAMILIES["checkerboard"]))
        off += gi
    return ChannelCBCards(cards, groups)


def portable_ccb_encode(cards: ChannelCBCards, y_q: np.ndarray, psi_fix: np.ndarray,
                        native: bool = True) -> bytes:
    """Encode one channel-conditional checkerboard latent grid on the
    integer path: per group, the checkerboard two-pass coder over the
    group's channels with the row [channel context || psi]; the groups chain
    on the exact latents (what decode reconstructs). Payload: G uint32
    block lengths, then the groups' streams."""
    y_int = np.asarray(y_q)
    blocks = []
    off = 0
    for i, gi in enumerate(cards.groups):
        psi_i = psi_fix if i == 0 else np.concatenate(
            [cards.channel_forward(i, y_int[..., :off], native=native), psi_fix], axis=-1)
        blocks.append(portable_cb_encode(cards.cards[i], y_int[..., off:off + gi], psi_i,
                                         native=native))
        off += gi
    return struct.pack(f"<{len(blocks)}I", *map(len, blocks)) + b"".join(blocks)


def portable_ccb_decode(cards: ChannelCBCards, data: bytes, psi_fix: np.ndarray,
                        h: int, w: int, native: bool = True) -> np.ndarray:
    """Decode one channel-conditional checkerboard latent grid -> (h, w, M)
    float32 integers. Decoded escapes are Y_ABS_MAX-bounded inside
    ``portable_cb_decode``, so every channel_forward input stays in spec."""
    G = len(cards.groups)
    if len(data) < 4 * G:
        raise ValueError("corrupt or truncated portable channel_cb stream")
    lens = struct.unpack(f"<{G}I", data[:4 * G])
    if 4 * G + sum(lens) != len(data):
        raise ValueError("corrupt portable channel_cb stream: the block table does not cover "
                         "the payload")
    y_out = np.zeros((h, w, cards.M), np.float32)
    start = 4 * G
    off = 0
    for i, gi in enumerate(cards.groups):
        psi_i = psi_fix if i == 0 else np.concatenate(
            [cards.channel_forward(i, y_out[..., :off], native=native), psi_fix], axis=-1)
        y_out[..., off:off + gi] = portable_cb_decode(cards.cards[i], data[start:start + lens[i]],
                                                      psi_i, h, w, native=native)
        off += gi
        start += lens[i]
    return y_out


# --- the factorized prior's card: frozen tables -----------------------------------

class FactorizedCard:
    """Portable artifact of a FactorizedPrior: its per-channel tables frozen
    over a fixed range. The float tables are rebuilt per range and machine;
    frozen, a stream decodes anywhere, since the indexed rANS coder is exact
    integer code."""

    def __init__(self, cdfs: np.ndarray, offsets: np.ndarray, sizes: np.ndarray,
                 ymin: int, ymax: int):
        self.cdfs = cdfs.astype(np.uint32)
        self.offsets = np.asarray(offsets, np.int32)
        self.sizes = np.asarray(sizes, np.int32)
        self.ymin = ymin
        self.ymax = ymax
        h = hashlib.sha256()
        for arr in (np.array([ymin, ymax], np.int64), self.cdfs, self.offsets, self.sizes):
            h.update(np.ascontiguousarray(arr).tobytes())
        self.hash = h.digest()[:8]

    @classmethod
    def build(cls, model, ymin: int = -256, ymax: int = 256) -> "FactorizedCard":
        """The model's tables over [ymin, ymax] (``cdf_tables
        .factorized_tables`` on the model's device)."""
        from neural_image_compression_tpu_torch.coding.cdf_tables import factorized_tables

        return cls(*factorized_tables(model, ymin, ymax), ymin, ymax)

    def save(self, path: str) -> None:
        np.savez_compressed(path, cdfs=self.cdfs, offsets=self.offsets, sizes=self.sizes,
                            meta=np.array([self.ymin, self.ymax], np.int64))

    @classmethod
    def load(cls, path: str) -> "FactorizedCard":
        with np.load(path) as d:
            ymin, ymax = (int(v) for v in d["meta"])
            return cls(d["cdfs"], d["offsets"], d["sizes"], ymin, ymax)


def save_scalable_cards(path: str, cards) -> None:
    """One file for ``ScalableCodec``'s two cards (base, enhancement): each
    card's arrays under the prefix ``l1_`` or ``l2_`` in one npz, the JAX
    package's format."""
    arrays = {}
    for prefix, card in zip(("l1_", "l2_"), cards):
        arrays.update({prefix + k: v for k, v in card._arrays()})
    np.savez_compressed(path, **arrays)


def load_scalable_cards(path: str) -> Tuple[PortableCard, PortableCard]:
    """``save_scalable_cards``' inverse: (base card, enhancement card)."""
    d = np.load(path)
    cards = []
    for prefix in ("l1_", "l2_"):
        sub = {k[len(prefix):]: d[k] for k in d.files if k.startswith(prefix)}
        if not sub:
            raise ValueError(f"{path} is not a scalable card pair (missing {prefix}* arrays)")
        cards.append(PortableCard._from_mapping(sub))
    return cards[0], cards[1]
