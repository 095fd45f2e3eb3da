"""PyTorch port, kernel wrappers: input checks, plain versions (forward and
backward, the backward held against autograd of the plain forward) and the
autograd plumbing on the CPU and, on a CUDA card only, each hand-written
kernel against its plain version, and the scalable model's kernel launches,
its LatentSpaceTransform against the CPU and its codec's round trip. This
file imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

import functools
import re
from pathlib import Path

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


@pytest.mark.parametrize("c", [16, 128, 192, 256])
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


def _backward_terms(n, x, g, inverse, ulps=2, seed=0):
    """t and d1 from the norm, in float32 as the norm launch's epilogue
    computes them (`terms`): both directions from r = rsqrt(n), IGDN's
    sqrt(n) as n * r. The card's rsqrtf is within 2 ulp of the correctly
    rounded value, so r here is that value moved ``ulps`` up or down (a
    seeded draw an element): the emulation carries the kernel's error
    bound, not a better r."""
    n = n.astype(np.float32)
    r = (1.0 / np.sqrt(n.astype(np.float64))).astype(np.float32)
    away = np.where(np.random.default_rng(seed).random(r.shape) < 0.5,
                    np.float32(0.0), np.float32(np.inf))
    for _ in range(ulps):
        r = np.nextafter(r, away)
    if inverse:
        return g * x * r, g * (n * r)
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
@pytest.mark.parametrize("c", [16, 128, 192, 256])
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
@pytest.mark.parametrize("c", [16, 128, 192, 256])
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


@pytest.mark.parametrize("c", [16, 128, 192, 256])
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


# csrc/gdn_wide.cuh asserts the wide forward's geometry for each of its four
# instantiations; the wrapper's mirror (chip_smoke.py prints it) must agree
_WIDE_ASSERT = re.compile(
    r"static_assert\(Wide<(float|__nv_bfloat16), (\d+)>::S == (\d+)\s*&&\s*"
    r"Wide<\1, \2>::NB == (\d+)\s*&&\s*Wide<\1, \2>::CONSUMERS == (\d+)\s*&&\s*"
    r"Wide<\1, \2>::STAGES == (\d+)\s*&&\s*Wide<\1, \2>::SMEM == (\d+)")


@pytest.mark.parametrize("c,element_size", [(192, 4), (256, 4), (192, 2), (256, 2)])
def test_wide_geometry_mirrors_the_sizes_csrc_asserts(c, element_size):
    source = (Path(gdn_kernel.__file__).resolve().parents[2] / "csrc" / "gdn_wide.cuh").read_text()
    asserted = {(int(cp), 4 if t == "float" else 2): tuple(map(int, rest))
                for t, cp, *rest in _WIDE_ASSERT.findall(source)}
    assert len(asserted) == 4
    geo = gdn_kernel.wide_geometry(c, element_size)
    assert (geo["cluster"], geo["nb"], geo["consumers"], geo["stages"],
            geo["smem"]) == asserted[c, element_size]
    assert geo["tile_rows"] == 64 * geo["consumers"]
    # every width the loop serves pads to one of the asserted instantiations
    for width in (c - 63, c - 1):
        assert gdn_kernel.wide_geometry(width, element_size) == geo
    assert geo["smem"] <= 232448 and geo["cluster"] * geo["nb"] == geo["cp"]


# and the backward's norm and mix launches on the same loop, and its fused
# launch at 65 to 128 channels: one assert for each (launch, ring type,
# width) instantiation (the mix's ring is float32 t whatever x's type)
_WIDE_BWD_ASSERT = re.compile(
    r"static_assert\(Wide<(float|__nv_bfloat16), (\d+), WIDE_(NORM|MIX|BACKWARD)>::S == (\d+)\s*&&\s*"
    r"Wide<\1, \2, WIDE_\3>::NB == (\d+)\s*&&\s*Wide<\1, \2, WIDE_\3>::CONSUMERS == (\d+)"
    r"\s*&&\s*Wide<\1, \2, WIDE_\3>::STAGES == (\d+)\s*&&\s*Wide<\1, \2, WIDE_\3>::SMEM == "
    r"(\d+)")


@pytest.mark.parametrize("launch,c,element_size", [
    ("norm", 192, 4), ("norm", 256, 4), ("norm", 192, 2), ("norm", 256, 2),
    ("mix", 192, 4), ("mix", 256, 4), ("mix", 192, 2), ("mix", 256, 2),
    ("backward", 128, 4), ("backward", 128, 2)])
def test_wide_backward_geometry_mirrors_the_sizes_csrc_asserts(launch, c, element_size):
    source = (Path(gdn_kernel.__file__).resolve().parents[2] / "csrc" / "gdn_wide.cuh").read_text()
    asserted = {(launch_.lower(), int(cp), 4 if t == "float" else 2): tuple(map(int, rest))
                for t, cp, launch_, *rest in _WIDE_BWD_ASSERT.findall(source)}
    # norm: 2 types x 2 widths; mix: float32 t x 2 widths; the fused launch: 2 types at 128
    assert len(asserted) == 8
    ring = 4 if launch == "mix" else element_size
    geo = gdn_kernel.wide_geometry(c, element_size, launch)
    assert (geo["cluster"], geo["nb"], geo["consumers"], geo["stages"],
            geo["smem"]) == asserted[launch, c, ring]
    # two consumers share each tile, 64 rows each
    assert geo["consumers"] == 2 and geo["tile_rows"] == 64 * geo["consumers"]
    for width in (c - 63, c - 1):
        assert gdn_kernel.wide_geometry(width, element_size, launch) == geo
    assert geo["smem"] <= 232448 and geo["cluster"] * geo["nb"] == geo["cp"]
    # the norm's product is the forward's: the same clusters and slices
    if launch == "norm":
        forward = gdn_kernel.wide_geometry(c, element_size)
        assert (geo["cluster"], geo["nb"]) == (forward["cluster"], forward["nb"])
    # the fused launch: a block holds both layouts of its 64 channels (P in
    # x's type, Q in TF32) and a consumer's t for the partner, 16 KB
    if launch == "backward":
        planes = 2 * geo["nb"] * geo["cp"] * (element_size + 4)
        assert geo["exchange"] == geo["consumers"] * 128 * (geo["nb"] // 2) * 4 == 32768
        assert planes + geo["exchange"] + geo["stages"] * geo["tile_rows"] * 128 <= 232448 - 2048


def test_wide_geometry_refuses_an_unknown_launch():
    with pytest.raises(ValueError, match="launch must be one of"):
        gdn_kernel.wide_geometry(192, 4, "partials")


def test_wide_geometry_refuses_the_narrow_widths():
    with pytest.raises(ValueError, match="129 to 256"):
        gdn_kernel.wide_geometry(128, 4)
    with pytest.raises(ValueError, match="129 to 256"):
        gdn_kernel.wide_geometry(257, 2)


@pytest.mark.parametrize("launch", ["forward", "norm", "mix"])
@pytest.mark.parametrize("c", [65, 100, 128])
def test_wide_geometry_keeps_65_to_128_channels_for_the_fused_launch(launch, c):
    # the forward, norm and mix launches stay off the cluster loop at C <= 128
    with pytest.raises(ValueError, match="129 to 256"):
        gdn_kernel.wide_geometry(c, 4, launch)
    assert gdn_kernel.wide_geometry(c, 4, "backward")["cp"] == 128


@pytest.mark.parametrize("c", [1, 64, 129, 192, 256])
def test_fused_geometry_refuses_the_other_widths(c):
    with pytest.raises(ValueError, match="65 to 128"):
        gdn_kernel.wide_geometry(c, 2, "backward")


@pytest.mark.parametrize("bf16", [False, True])
def test_backward_scratch_holds_t_only_for_the_dgamma_stage_at_cp_128(bf16):
    # the fused launch keeps t and d1 in registers: no scratch for dx alone,
    # t alone (for the partials launch) with the dgamma/dbeta stage; the
    # other widths keep t, and d1 for bfloat16 rows, in the scratch
    n = 100_003
    chunks = gdn_kernel._chunking(n)[1]
    for c in (65, 100, 112, 128):
        assert gdn_kernel._scratch_floats(n, c, bf16, False, chunks) == 0
        assert gdn_kernel._scratch_floats(n, c, bf16, True, chunks) == (
            n * c + chunks * c * (c + 1))
    for c in (16, 64, 192, 256):
        rows = n * c * (2 if bf16 else 1)
        assert gdn_kernel._scratch_floats(n, c, bf16, False, chunks) == rows
        assert gdn_kernel._scratch_floats(n, c, bf16, True, chunks) == (
            rows + chunks * c * (c + 1))


def _cluster_products(a, b, c, element_size, launch, rnd):
    """a @ b as csrc/gdn_wide.cuh's cluster loop takes it for ``launch``
    ("norm": a = x*x, b = gamma; "mix": a = t, b = gamma^T): both operands
    zero-padded to the padded width and split into hi and lo by ``rnd``;
    block rank r of the cluster computes its output channels [r NB, (r + 1)
    NB) with K over the whole padded width, box by box (128 bytes of the
    ring's type) and k-step by k-step (32 bytes) in the kernel's order, the
    three products of each step (lo*hi, hi*lo, hi*hi) each summed exactly
    and added into a float32 accumulator."""
    geo = gdn_kernel.wide_geometry(c, element_size, launch)
    cp, nb = geo["cp"], geo["nb"]
    ring = 4 if launch == "mix" else element_size
    cols, kstep = 128 // ring, 32 // ring
    ap = np.zeros((a.shape[0], cp), np.float32)
    ap[:, :c] = a
    bp = np.zeros((cp, cp), np.float32)
    bp[:c, :c] = b
    a_hi, a_lo = _split(ap, rnd)
    b_hi, b_lo = _split(bp, rnd)
    acc = np.zeros_like(ap)
    for r in range(geo["cluster"]):
        o = slice(r * nb, (r + 1) * nb)
        for box in range(cp // cols):
            for ks in range(4):
                k = slice(box * cols + ks * kstep, box * cols + (ks + 1) * kstep)
                for pa, pb in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
                    acc[:, o] += (pa[:, k].astype(np.float64) @ pb[k, o]).astype(np.float32)
    return acc[:, :c]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [192, 200, 256])
def test_cluster_launches_keep_dx_dgamma_dbeta(c, dtype, inverse):
    # csrc/gdn_bwd_kernel.cu at C = 192 and 256 (200 pads to 256): launches
    # 1 and 2 on the cluster loop, each rank's products over its slice of
    # the outputs and t, d1 from one rsqrt, then launches 3 and 4
    # (unchanged) on the float32 t of launch 1; dx before its rounding to
    # x's type
    x, gamma, beta = _gdn_operands(8192, c, seed=500 + c)
    g = np.random.default_rng(600 + c).standard_normal(x.shape, dtype=np.float32)
    esz, rnd = 4, _tf32_rna
    if dtype == "bfloat16":
        x, g, esz, rnd = _bf16(x), _bf16(g), 2, _bf16
    n = _cluster_products(x * x, gamma, c, esz, "norm", rnd) + beta
    t, d1 = _backward_terms(n, x, g, inverse)
    u = _cluster_products(t, gamma.T, c, esz, "mix", _tf32_rna)
    dx = d1 + np.float32(1.0 if inverse else -1.0) * x * u
    s_hi, s_lo = (_by_chunk(a, x.shape[0]) for a in _split_rna_trunc(x * x))
    squares = np.ascontiguousarray(np.concatenate([s_lo, s_hi, s_hi], axis=1).transpose(0, 2, 1))
    sums, tsums = _partials_launch(squares, t)
    half = np.float32(0.5 if inverse else -0.5)
    want_dx, want_dgamma, want_dbeta = _backward_float64(x, gamma, beta, g, inverse)
    assert _within_backward_tolerance(dx, want_dx)
    assert _within_backward_tolerance(half * sums, want_dgamma)
    assert _within_backward_tolerance(half * tsums, want_dbeta)


def _fused_backward(x, gamma, beta, g, c, element_size, inverse, rnd):
    """dx before its rounding to x's type, and t, as csrc/gdn_bwd_kernel.cu's
    fused launch computes them at 65 to 128 channels. Block rank r of the
    cluster owns channels [r NB, (r + 1) NB): its norm over them with K over
    the whole padded width in the kernel's box and k-step order
    (``_cluster_products``); t and d1 from one rsqrt; its half of t, float32
    as it is, into the partner's exchange buffer; then u for its channels
    over all k, k-steps of 8 in channel order, its own half of t from its
    registers and the partner's from the exchange, each split into TF32 hi
    and lo against gamma's Q planes (TF32 hi and lo), the three products of
    a step each summed exactly and added into a float32 accumulator."""
    geo = gdn_kernel.wide_geometry(c, element_size, "backward")
    cp, nb, ranks = geo["cp"], geo["nb"], geo["cluster"]
    n = _cluster_products(x * x, gamma, c, element_size, "backward", rnd) + beta
    t, d1 = _backward_terms(n, x, g, inverse)
    tp = np.zeros((x.shape[0], cp), np.float32)
    tp[:, :c] = t
    gq = np.zeros((cp, cp), np.float32)
    gq[:c, :c] = gamma.T  # u = t . gamma^T
    halves = [tp[:, r * nb:(r + 1) * nb] for r in range(ranks)]
    exchange = {1 - r: halves[r].copy() for r in range(ranks)}  # what rank 1 - r receives
    q_hi, q_lo = _split(gq, _tf32_rna)
    u = np.zeros_like(tp)
    for r in range(ranks):
        a = np.concatenate([halves[r] if q == r else exchange[r] for q in range(ranks)], axis=1)
        a_hi, a_lo = _split(a, _tf32_rna)
        o = slice(r * nb, (r + 1) * nb)
        for k0 in range(0, cp, 8):
            k = slice(k0, k0 + 8)
            for pa, pb in ((a_lo, q_hi), (a_hi, q_lo), (a_hi, q_hi)):
                u[:, o] += (pa[:, k].astype(np.float64) @ pb[k, o]).astype(np.float32)
    return d1 + np.float32(1.0 if inverse else -1.0) * x * u[:, :c], t


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [128, 100])
def test_fused_launch_keeps_dx_dgamma_dbeta(c, dtype, inverse):
    # csrc/gdn_bwd_kernel.cu at 65 to 128 channels (100: the padded channels
    # masked): the fused launch's two products, t exchanged between the
    # cluster's blocks, then launches 3 and 4 (unchanged) on the t it writes
    x, gamma, beta = _gdn_operands(8192, c, seed=700 + c)
    g = np.random.default_rng(800 + c).standard_normal(x.shape, dtype=np.float32)
    esz, rnd = 4, _tf32_rna
    if dtype == "bfloat16":
        x, g, esz, rnd = _bf16(x), _bf16(g), 2, _bf16
    dx, t = _fused_backward(x, gamma, beta, g, c, esz, inverse, rnd)
    # the two launches it replaces: the norm's t written as float32, read
    # back whole by the mix over all outputs at once, in the same k order
    n = _cluster_products(x * x, gamma, c, esz, "backward", rnd) + beta
    t2, d1 = _backward_terms(n, x, g, inverse)
    u = np.zeros(x.shape, np.float32)
    t_hi, t_lo = _split(t2, _tf32_rna)
    q_hi, q_lo = _split(gamma.T.copy(), _tf32_rna)
    for k0 in range(0, c, 8):
        k = slice(k0, k0 + 8)
        for pa, pb in ((t_lo, q_hi), (t_hi, q_lo), (t_hi, q_hi)):
            u += (pa[:, k].astype(np.float64) @ pb[k, :]).astype(np.float32)
    np.testing.assert_array_equal(t, t2)
    np.testing.assert_array_equal(dx, d1 + np.float32(1.0 if inverse else -1.0) * x * u)
    s_hi, s_lo = (_by_chunk(a, x.shape[0]) for a in _split_rna_trunc(x * x))
    squares = np.ascontiguousarray(np.concatenate([s_lo, s_hi, s_hi], axis=1).transpose(0, 2, 1))
    sums, tsums = _partials_launch(squares, t)
    half = np.float32(0.5 if inverse else -0.5)
    want_dx, want_dgamma, want_dbeta = _backward_float64(x, gamma, beta, g, inverse)
    assert _within_backward_tolerance(dx, want_dx)
    assert _within_backward_tolerance(half * sums, want_dgamma)
    assert _within_backward_tolerance(half * tsums, want_dbeta)


def _split_rna_trunc(a):
    """a -> TF32 hi and lo as the partials launch splits it: hi rounded to
    nearest (ties away), lo = a - hi exact in float32 and truncated to TF32
    by the tensor cores, which ignore its low 13 bits."""
    hi = _tf32_rna(a)
    lo = np.ascontiguousarray(a - hi, dtype=np.float32).view(np.uint32) & np.uint32(0xFFFFE000)
    return hi, lo.view(np.float32)


def _by_chunk(a, n):
    """(n, c) rows -> (chunks, rows, c) in the backward's chunks, zero padded."""
    rows, chunks = gdn_kernel._chunking(n)
    out = np.zeros((chunks * rows, a.shape[1]), a.dtype)
    out[:n] = a
    return out.reshape(chunks, rows, -1)


@functools.lru_cache(maxsize=1)
def _partials_rows(c, dtype):
    """65,536 rows of x and g, gamma and beta; the norm as the norm launch
    computes it (3xTF32 for float32 x, 3xbf16 for bfloat16 x) and in
    float64; x*x split into TF32 hi and lo as the partials launch takes it,
    chunk by chunk: (chunks, c, 3 * rows) of [lo, hi, hi] over the rows."""
    x, gamma, beta = _gdn_operands(65_536, c, seed=400 + c)
    g = np.random.default_rng(c).standard_normal(x.shape, dtype=np.float32)
    rnd = _tf32_rna
    if dtype == "bfloat16":
        x, g, rnd = _bf16(x), _bf16(g), _bf16
    n = _split_product(x * x, gamma, rnd) + beta
    x64 = x.astype(np.float64)
    n64 = (x64 * x64) @ gamma.astype(np.float64) + beta
    s_hi, s_lo = (_by_chunk(a, x.shape[0]) for a in _split_rna_trunc(x * x))
    squares = np.concatenate([s_lo, s_hi, s_hi], axis=1).transpose(0, 2, 1)
    return x, g, n, n64, np.ascontiguousarray(squares)


def _partials_launch(squares, t):
    """(x*x)^T @ t and the column sums of t as csrc/gdn_bwd_kernel.cu's
    partials launch takes them, then summed as its reduce launch: per chunk
    of ``_chunking(n)`` rows, the three products of x*x's and t's TF32 hi
    and lo (``_split_rna_trunc``; lo @ lo dropped) summed into one float32
    accumulator and t
    summed in float32; then the chunks' partials summed in float32 in chunk
    order. squares: ``_partials_rows``'s."""
    t_hi, t_lo = (_by_chunk(a, t.shape[0]) for a in _split_rna_trunc(t))
    part = np.matmul(squares, np.concatenate([t_hi, t_lo, t_hi], axis=1))  # float32 sums
    part_beta = _by_chunk(t, t.shape[0]).sum(axis=1, dtype=np.float32)
    assert part.dtype == part_beta.dtype == np.float32
    dgamma, dbeta = np.zeros(part.shape[1:], np.float32), np.zeros(t.shape[1], np.float32)
    for z in range(part.shape[0]):
        dgamma += part[z]
        dbeta += part_beta[z]
    return dgamma, dbeta


def _partials_case(c, dtype, inverse):
    """squares, t as the norm launch writes it (float32) and dgamma, dbeta
    in float64 from the same inputs, with the sign's half."""
    x, g, n, n64, squares = _partials_rows(c, dtype)
    # r correctly rounded: the tolerance here is a tenth, for the partials'
    # products; the tests of launches 1 and 2 hold r's 2 ulp to the whole
    t = _backward_terms(n, x, g, inverse, ulps=0)[0]
    root = np.sqrt(n64)
    t64 = g * x / root if inverse else g * x / (n64 * root)
    half = 0.5 if inverse else -0.5
    x64 = x.astype(np.float64)
    return squares, t, half, half * ((x64 * x64).T @ t64), half * t64.sum(axis=0)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [16, 128, 192])
def test_partials_launch_three_tf32_products_keep_dgamma_dbeta(c, dtype, inverse):
    # csrc/gdn_bwd_kernel.cu launches 3 and 4: dgamma and dbeta from 3xTF32
    # products over float32 chunk sums, within a tenth of the backward's
    # tolerance (rows of 65,536: 256 chunks of 256)
    squares, t, half, want_dgamma, want_dbeta = _partials_case(c, dtype, inverse)
    sums, tsums = _partials_launch(squares, t)
    assert _within_backward_tolerance(np.float32(half) * sums, want_dgamma, shrink=10.0)
    assert _within_backward_tolerance(np.float32(half) * tsums, want_dbeta, shrink=10.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_partials_launch_single_tf32_product_fails_the_tolerance(dtype):
    # why the partials launch splits its operands: x*x and t rounded to TF32
    # once, the one product summed exactly, miss the backward's tolerance
    squares, t, half, want_dgamma, _ = _partials_case(16, dtype, False)
    x, *_ = _partials_rows(16, dtype)
    single = half * (_tf32_rna(x * x).astype(np.float64).T @ _tf32_rna(t))
    assert not _within_backward_tolerance(single, want_dgamma)
    assert _within_backward_tolerance(half * _partials_launch(squares, t)[0], want_dgamma)


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
# padded route; 192, 200 and 256 the wide loop (csrc/gdn_wide.cuh: clusters
# walking tiles of 128 or 192 rows) at 1, 63 and 65 rows, at 4,099 rows (33
# or 22 tiles) and at 8,581 (68 or 45 tiles: more tiles than some clusters
# of 4, so clusters walk unequal numbers of tiles); one 128-row tile and the
# scalable model's LST train rows, whole (16,384) and ragged (16,387)
@pytest.mark.parametrize("n,c", [(1000, 128), (77, 100), (300, 16), (513, 256),
                                 (100003, 128), (4096, 192), (64, 10),
                                 (1, 192), (63, 192), (65, 200), (4_099, 200), (8_581, 192),
                                 (1, 256), (63, 256), (65, 256), (4_099, 256), (8_581, 256)]
                         + [(n, c) for c in (192, 200, 256) for n in (128, 16_384, 16_387)])
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_gdn_launches_once_a_call_on_card(cuda_device, dtype):
    # a C=192 and a C=256 call (the wide loop: one cluster launch each, the
    # LST's 294,912 rows at 256) each add one to the count, as C=128 does
    rng = np.random.default_rng(6)
    for n, c in ((4_096, 192), (294_912, 256), (4_096, 128)):
        x = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32)).to(cuda_device, dtype)
        gamma = torch.eye(c, device=cuda_device) * 0.1
        beta = torch.ones(c, device=cuda_device)
        before = gdn_kernel.gdn.launches
        gdn_kernel.gdn(x, gamma, beta, True)
        gdn_kernel.gdn(x, gamma, beta)
        torch.cuda.synchronize()
        assert gdn_kernel.gdn.launches == before + 2


# The main path's three shapes (serve, train step, refinement), rows that
# leave a ragged last tile (read straight from device memory), M = 1 and
# M = 100 (rows that are no multiple of 16 bytes), K = 8, contiguous views
# one float past an aligned address (every tile read directly) and N = 0.
# Each case: (n, k, m, storage offset of every input).
_GMM_CARD_CASES = [(1000, 3, 128, 0), (37, 1, 100, 0), (50, 8, 16, 0), (73_728, 3, 128, 0),
                   (4_096, 3, 128, 0), (1_536, 3, 128, 0), (4_099, 3, 128, 0),
                   (1_001, 3, 1, 0), (1_003, 2, 100, 0), (4_099, 8, 128, 0),
                   (4_096, 3, 128, 1), (1_001, 2, 100, 1), (0, 3, 128, 0)]


def _at_offset(t, offset):
    """t's values in a contiguous view `offset` floats into its storage."""
    if not offset:
        return t
    out = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)[offset:].view_as(t)
    return out.copy_(t)


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,m,offset", _GMM_CARD_CASES)
def test_gmm_kernel_matches_plain_on_card(cuda_device, n, k, m, offset):
    args = [torch.from_numpy(a).to(cuda_device) for a in mixture_symbols(n, k, m, seed=5)]
    shifted = [_at_offset(t, offset) for t in args]
    before = gmm_kernel.gmm_logp.launches
    got = gmm_kernel.gmm_logp(*shifted)
    torch.cuda.synchronize()
    assert gmm_kernel.gmm_logp.launches == before + (n > 0)
    assert got.shape == (n, m)
    want = gmm_kernel.mixture_log_likelihood_reference(*args)
    bulk = want > np.log(1e-6)
    torch.testing.assert_close(got[bulk], want[bulk], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.double().sum().item(), want.double().sum().item(), rtol=1e-6)
    if offset:  # the direct route gives the ring's bits
        assert torch.equal(got, gmm_kernel.gmm_logp(*args))


@pytest.mark.cuda
def test_gmm_kernels_repeat_their_bits_on_card(cuda_device):
    # no atomics, no order that depends on timing: two runs, the same bits
    n, k, m = 4_096, 3, 128
    arrays = _mixture_with_tails(n, k, m, seed=9)
    inputs = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    g = torch.from_numpy(np.random.default_rng(10).normal(size=(n, m)).astype(np.float32)).to(
        cuda_device)
    assert torch.equal(gmm_kernel.gmm_logp(*inputs), gmm_kernel.gmm_logp(*inputs))
    first = gmm_kernel.gmm_logp_backward(*inputs, g)
    again = gmm_kernel.gmm_logp_backward(*inputs, g)
    for a, b in zip(first, again):
        assert torch.equal(a, b)


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
# the widths where a cluster holds gamma in slices: 192, 256), widths that leave
# ragged 64-channel groups, and widths the wrapper pads (10; 100 in bf16);
# the dgamma/dbeta partials launch's edges: fewer rows than one 32-row tile
# (1), a ragged second tile (63), a last chunk of 3 rows (16,387: 64 chunks
# of 256, then 3), a width that leaves half of the second dgamma tile empty
# (200), the residual family's H/2 site (262,144 x 192); the norm and mix
# launches' cluster loop at C = 192, 200 and 256 (two consumers sharing
# 128-row tiles): fewer rows than a consumer's 64, one tile whose second
# consumer has one row (65), one whole tile (128), 33 and 68 tiles (more
# than some clusters take: clusters walk unequal numbers), the LST's train
# rows, whole and ragged
@pytest.mark.parametrize("n,c", [(262_144, 128), (65_536, 128), (16_384, 128),
                                 (100_003, 128), (77, 100), (300, 16), (513, 256),
                                 (4096, 192), (64, 10), (1001, 192), (70, 256),
                                 (1001, 10), (1, 128), (63, 128), (63, 10), (16_387, 128),
                                 (16_387, 200), (1, 256), (16_387, 256), (1, 200),
                                 (262_144, 192), (100_003, 200)]
                         + [(n, c) for c in (192, 200, 256)
                            for n in (1, 63, 65, 128, 4_099, 8_581, 16_384, 16_387)
                            if (n, c) not in ((1, 200), (1, 256), (16_387, 200), (16_387, 256))])
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
    # no atomics, chunks fixed by n: a second run gives the same bits, with
    # its scratch elsewhere
    held = torch.empty(n * c, device=cuda_device)  # noqa: F841
    again = gdn_kernel.gdn_backward(x, gamma, beta, g, inverse)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,c", [(98_304, 128), (1001, 10), (98_304, 192)]
                         + [(n, c) for c in (192, 200, 256)
                            for n in (1, 63, 65, 128, 4_099, 8_581, 16_384, 16_387)])
def test_gdn_backward_dx_only_on_card(cuda_device, dtype, n, c, inverse):
    # without the dgamma/dbeta stage: the same dx bits, one launch, no stage
    x, gamma, beta, g = (t.to(cuda_device) for t in _gdn_case(n, c, seed=4))
    x, g = x.to(dtype), g.to(dtype)
    full = gdn_kernel.gdn_backward(x, gamma, beta, g, inverse)
    before = (gdn_kernel.gdn_backward.launches, gdn_kernel.gdn_backward.param_launches)
    dx, dgamma, dbeta = gdn_kernel.gdn_backward(x, gamma, beta, g, inverse, param_grads=False)
    torch.cuda.synchronize()
    assert (gdn_kernel.gdn_backward.launches, gdn_kernel.gdn_backward.param_launches) == (
        before[0] + 1, before[1])
    assert dgamma is None and dbeta is None
    assert torch.equal(dx, full[0])


@pytest.mark.cuda
@pytest.mark.parametrize("param_grads", [True, False])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
# the fused launch at 65 to 128 channels (clusters of two blocks walking
# 128-row tiles, t exchanged between them): fewer rows than a consumer's 64
# and than a tile, one tile, one tile and one row, 33 tiles, 67 and 133
# (odd: the first cluster takes one more tile than the others on an H100,
# which holds 66 clusters), 68, 129; at C = 128 and at 100 (float32 rows as
# they are, the channels past 100 masked; bfloat16 rows padded to 112)
@pytest.mark.parametrize("n,c", [(n, c) for c in (128, 100)
                                 for n in (1, 63, 65, 128, 129, 4_099, 8_575, 8_581, 16_387,
                                           16_999)])
def test_fused_backward_matches_plain_on_card(cuda_device, dtype, inverse, param_grads, n, c):
    x, gamma, beta, g = (t.to(cuda_device) for t in _gdn_case(n, c, seed=7))
    x, g = x.to(dtype), g.to(dtype)
    before = (gdn_kernel.gdn_backward.launches, gdn_kernel.gdn_backward.param_launches)
    got = gdn_kernel.gdn_backward(x, gamma, beta, g, inverse, param_grads)
    torch.cuda.synchronize()
    assert (gdn_kernel.gdn_backward.launches, gdn_kernel.gdn_backward.param_launches) == (
        before[0] + 1, before[1] + int(param_grads))
    want = gdn_kernel.gdn_backward_reference(x, gamma, beta, g, inverse, param_grads)
    _assert_grad_close(got[0], want[0], "dx", dtype)
    if param_grads:
        _assert_grad_close(got[1], want[1], "dgamma")
        _assert_grad_close(got[2], want[2], "dbeta")
    else:
        assert got[1] is None and got[2] is None
        assert torch.equal(got[0], gdn_kernel.gdn_backward(x, gamma, beta, g, inverse)[0])
    again = gdn_kernel.gdn_backward(x, gamma, beta, g, inverse, param_grads)
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gdn_backward_wide_rows_at_an_unaligned_address_on_card(cuda_device, dtype):
    # C = 192 rows 4 bytes past an aligned address: the cluster loop runs on
    # the wrapper's aligned, padded copies, and gives the aligned rows' bits
    x, gamma, beta, g = (t.to(cuda_device) for t in _gdn_case(4_099, 192, seed=5))
    x, g = x.to(dtype), g.to(dtype)
    shift = 4 // x.element_size()
    xs = torch.empty(x.numel() + shift, dtype=dtype, device=cuda_device)[shift:].view_as(x)
    gs = torch.empty(g.numel() + shift, dtype=dtype, device=cuda_device)[shift:].view_as(g)
    xs.copy_(x)
    gs.copy_(g)
    assert xs.data_ptr() % 16 and gs.data_ptr() % 16
    got = gdn_kernel.gdn_backward(xs, gamma, beta, gs)
    want = gdn_kernel.gdn_backward_reference(x, gamma, beta, g)
    for name, a, b in zip(("dx", "dgamma", "dbeta"), got, want):
        _assert_grad_close(a, b, name, dtype if name == "dx" else torch.float32)
    for a, b in zip(got, gdn_kernel.gdn_backward(x, gamma, beta, g)):
        assert torch.equal(a, b)


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
@pytest.mark.parametrize("n,k,m,offset", _GMM_CARD_CASES)
def test_gmm_backward_kernel_matches_plain_on_card(cuda_device, n, k, m, offset):
    arrays = _mixture_with_tails(n, k, m, seed=6) if n >= 2 else mixture_symbols(n, k, m, seed=6)
    inputs = [torch.from_numpy(a).to(cuda_device) for a in arrays]
    g = torch.from_numpy(np.random.default_rng(8).normal(size=(n, m)).astype(np.float32)).to(
        cuda_device)
    shifted = [_at_offset(t, offset) for t in inputs + [g]]
    before = gmm_kernel.gmm_logp_backward.launches
    got = gmm_kernel.gmm_logp_backward(*shifted)
    torch.cuda.synchronize()
    assert gmm_kernel.gmm_logp_backward.launches == before + (n > 0)
    assert [tuple(t.shape) for t in got] == [(n, m)] + [(n, k, m)] * 3
    if n == 0:
        return
    want = gmm_kernel.mixture_log_likelihood_backward_reference(*inputs, g)
    for name, a, b in zip(("dy", "dw", "dmu", "dsigma"), got, want):
        # both use CUDA's erff and expf; the K-sum and divisions may round apart
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6 * float(b.abs().max()), msg=name)
    assert torch.count_nonzero(got[0][0]) == 0
    if offset:  # the direct route gives the ring's bits
        for a, b in zip(got, gmm_kernel.gmm_logp_backward(*inputs, g)):
            assert torch.equal(a, b)


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


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [False, True], ids=["batched_gamma", "shared_gamma"])
def test_kernels_launch_under_vmap_and_grad_on_card(cuda_device, shared):
    """torch.func.vmap(torch.func.grad(...)) through gdn and gmm_logp
    launches the hand kernels: GDN once a replica forward and backward with
    each replica's own gamma/beta, once for all with shared ones (dx only);
    the mixture once for all, folded; results as a loop over replicas."""
    from torch.func import grad, vmap

    from neural_image_compression_tpu_torch.ops.kernels import reset_launch_counts

    reps, n, c, k = 3, 4096, 128, 3
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(reps, n, c)).astype(np.float32)).to(cuda_device)
    gamma = torch.from_numpy(np.abs(rng.normal(0, 0.05, (reps, c, c))).astype(np.float32)).to(
        cuda_device)
    beta = torch.from_numpy(rng.uniform(0.5, 1.5, (reps, c)).astype(np.float32)).to(cuda_device)
    y, w, mus, sigmas = (torch.from_numpy(np.stack(a)).to(cuda_device) for a in zip(
        *[mixture_symbols(n, k, c, seed) for seed in range(reps)]))

    def loss(x, gamma, beta, w, mus, sigmas):
        out = gdn_kernel.gdn(x, gamma, beta)
        return (out * out).sum() - gmm_kernel.gmm_logp(y[0] + 0 * out, w, mus, sigmas).sum()

    if shared:
        gamma, beta = gamma[0], beta[0]
        fn = vmap(grad(loss, argnums=(0, 3, 4, 5)), in_dims=(0, None, None, 0, 0, 0))
    else:
        fn = vmap(grad(loss, argnums=(0, 1, 2, 3, 4, 5)))
    reset_launch_counts()
    got = fn(x, gamma, beta, w, mus, sigmas)
    torch.cuda.synchronize()
    counts = launch_counts()
    gdn_launches = 1 if shared else reps
    assert counts == {"gdn": gdn_launches, "gmm_logp": 1, "gdn_backward": gdn_launches,
                      "gmm_logp_backward": 1,
                      "gdn_backward_params": 0 if shared else reps}, counts
    for i in range(reps):
        args = (x[i], gamma if shared else gamma[i], beta if shared else beta[i],
                w[i], mus[i], sigmas[i])
        want = grad(loss, argnums=(0, 3, 4, 5) if shared else (0, 1, 2, 3, 4, 5))(*args)
        for g, ww in zip(got, want):
            torch.testing.assert_close(g[i], ww, rtol=1e-5, atol=1e-5 * float(ww.abs().max()))
