// Native implementation of the PORTABLE (cross-machine deterministic)
// autoregressive wavefront codec. Exact integer mirror of
// coding/portable.py — every operation is fixed-point with defined
// rounding, so this C++ path and the numpy path produce bit-identical
// streams on any hardware (tests/test_portable.py asserts it both ways).
//
// The fixed-point spec lives in portable.py's module docstring: activations
// F=12, int16 weights with per-layer shifts, round-half-up requantization,
// leaky slope 41/4096, mu on a 1/64 sub-grid, sigma snapped to geometric
// bins with precomputed integer CDF tables, mixture weights via an exp LUT
// summing to exactly 2^16 — so each symbol's total mass is exactly 2^32 and
// frequency quantization is `1 + ((pmf * budget) >> 32)`.
//
// The psi half of EP layer 1 (P_acc, one row per pixel at accumulator
// scale) is computed by the caller (numpy int64 — integer math is
// machine-independent, so sharing it does not weaken portability) and
// passed in; this file owns the serial wavefront: context gather, integer
// GEMMs, symbol models, rANS.

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#if defined(__AVX512F__)
#define NIC_PORT_AVX512 1
#include <immintrin.h>
#endif

#include "rans_core.h"

using nic::Decoder;
using nic::Encoder;
using nic::cdf_find;

namespace {

constexpr int kF = 12;        // activation fractional bits
constexpr int kSub = 6;       // mu sub-grid bits (1/64)
constexpr int64_t kLeakyNum = 41;  // slope = 41 / 4096
constexpr int kExpShift = 5;  // F=12 -> 1/128 LUT steps
constexpr uint32_t kWScale = 1u << 16;
constexpr int32_t kYAbsMax = 1 << 24;  // = portable.py Y_ABS_MAX
// Minimum symbol-window half-span (= portable.py PORT_R_MIN, card v2 spec).
// Same rationale as rans_core.h kRMinWindow: overconfident models force
// escapes on exactly the symbols they mispredict; a wide floor prices the
// misses at <= 16 bits via the freq>=1 leak. Per-bin tables stay as-is —
// edges beyond a table's extent clamp to its endpoints (exact saturation).
constexpr int64_t kPortRMin = 32;

inline int64_t rsr(int64_t v, int s) {  // rshift_round
  // Mirror the numpy spec (portable.py rshift_round) for s <= 0: a plain
  // left shift. QuantLayer.quantize can legally emit sw == 0 (weights with
  // max-abs in (16383.5, 32767]); the old unguarded form shifted by -1 (UB).
  // multiply, not `v << -s`: left-shifting a negative value is UB in C++17
  if (s <= 0) return v * (int64_t{1} << (-s));
  return (v + (int64_t{1} << (s - 1))) >> s;
}

inline int64_t lrelu1(int64_t v) {
  return v >= 0 ? v : rsr(v * kLeakyNum, kF);
}

inline uint64_t isqrt_u64(uint64_t v) {
  uint64_t r = static_cast<uint64_t>(std::sqrt(static_cast<double>(v)));
  while (r > 0 && r * r > v) --r;
  while ((r + 1) * (r + 1) <= v) ++r;
  return r;
}

struct QLayer {
  std::vector<int16_t> w;  // (k, m) row-major
  std::vector<int64_t> b;  // (m,)
  int sw = 0;
  int kd = 0, md = 0;
  // IFMA fast-path derivatives (see gemm_panel_ifma): biased weights
  // w + 2^15 as uint16, and per-column correction
  // corr0[j] = colsum_w[j]*2^31 + kd*2^46.
  std::vector<uint16_t> wb;
  std::vector<int64_t> corr0;

  void finalize() {
    wb.resize(w.size());
    for (size_t i = 0; i < w.size(); ++i)
      wb[i] = static_cast<uint16_t>(w[i]) ^ 0x8000u;
    corr0.assign(md, static_cast<int64_t>(kd) * (int64_t{1} << 46));
    for (int k = 0; k < kd; ++k)
      for (int j = 0; j < md; ++j)
        corr0[j] += static_cast<int64_t>(w[static_cast<size_t>(k) * md + j]) *
                    (int64_t{1} << 31);
  }
};

bool use_avx512() {
  static const bool v = [] {
#ifdef NIC_PORT_AVX512
    return std::getenv("NIC_PORT_NO_AVX512") == nullptr;
#else
    return false;
#endif
  }();
  return v;
}

// out (n, md) = init + A (n, kd) @ W with init = bias row, or the existing
// contents of out when bias == nullptr. Exact integer, order-free.
void gemm_scalar(const int64_t* A, int n, const int16_t* W,
                 const int64_t* bias, int kd, int md, int64_t* out) {
  for (int i = 0; i < n; ++i) {
    const int64_t* a = A + static_cast<size_t>(i) * kd;
    int64_t* o = out + static_cast<size_t>(i) * md;
    if (bias) std::memcpy(o, bias, md * sizeof(int64_t));
    for (int k = 0; k < kd; ++k) {
      const int64_t av = a[k];
      if (av == 0) continue;
      const int16_t* wr = W + static_cast<size_t>(k) * md;
      for (int j = 0; j < md; ++j) o[j] += av * wr[j];
    }
  }
}

// Bias-narrow an int64 activation block for the IFMA kernel:
// dst[i] = (uint32)(a + 2^31) in a qword, rowsum[r] = sum of true a over
// the row. Returns true iff every value fits int32 (the fast-GEMM
// precondition).
bool to_biased(const int64_t* src, int rows, int kd, uint64_t* dst,
               int64_t* rowsum) {
  uint64_t m = 0;
  for (int r = 0; r < rows; ++r) {
    const int64_t* s = src + static_cast<size_t>(r) * kd;
    uint64_t* d = dst + static_cast<size_t>(r) * kd;
    int64_t acc = 0;
    for (int k = 0; k < kd; ++k) {
      const int64_t v = s[k];
      m |= static_cast<uint64_t>(v ^ (v >> 63));
      acc += v;
      d[k] = static_cast<uint64_t>(static_cast<uint32_t>(v)) ^ 0x80000000ull;
    }
    rowsum[r] = acc;
  }
  return m <= 0x7fffffffull;
}

#ifdef NIC_PORT_AVX512
#ifdef __AVX512IFMA__
// R-row panel of the exact GEMM via vpmadd52luq. Operands are biased
// non-negative (a' = a + 2^31 < 2^32, w' = w + 2^15 < 2^16), so every
// product a'*w' < 2^48 — below 2^52, meaning the "low 52 bits" IS the full
// product and each madd52 is one exact MAC. The bias expands to
//   sum a'w' = sum a*w + 2^15*rowsum_a + 2^31*colsum_w + kd*2^46,
// undone per element with QLayer::corr0 (col terms) and rowsum*2^15 —
// all int64-exact, so the result is bit-identical to gemm_scalar whenever
// to_biased accepted the block.
template <int R>
void gemm_panel_ifma(const uint64_t* Ab, int kd, const QLayer& L,
                     const int64_t* rowsum, const int64_t* bias,
                     int64_t* out) {
  const int md = L.md;
  const uint16_t* Wb = L.wb.data();
  int jb = 0;
  for (; jb + 16 <= md; jb += 16) {
    __m512i acc[R][2];
    for (int r = 0; r < R; ++r) {
      acc[r][0] = _mm512_setzero_si512();
      acc[r][1] = _mm512_setzero_si512();
    }
    const uint16_t* wp = Wb + jb;
    for (int k = 0; k < kd; ++k, wp += md) {
      const __m512i w0 = _mm512_cvtepu16_epi64(
          _mm_loadu_si128(reinterpret_cast<const __m128i*>(wp)));
      const __m512i w1 = _mm512_cvtepu16_epi64(
          _mm_loadu_si128(reinterpret_cast<const __m128i*>(wp + 8)));
      for (int r = 0; r < R; ++r) {
        const __m512i av = _mm512_set1_epi64(
            static_cast<int64_t>(Ab[static_cast<size_t>(r) * kd + k]));
        acc[r][0] = _mm512_madd52lo_epu64(acc[r][0], av, w0);
        acc[r][1] = _mm512_madd52lo_epu64(acc[r][1], av, w1);
      }
    }
    for (int r = 0; r < R; ++r) {
      int64_t* orow = out + static_cast<size_t>(r) * md + jb;
      const __m512i rs = _mm512_set1_epi64(rowsum[r] * (int64_t{1} << 15));
      for (int half = 0; half < 2; ++half) {
        const int64_t* init = bias ? bias + jb + 8 * half : orow + 8 * half;
        __m512i v = acc[r][half];
        v = _mm512_sub_epi64(v,
                             _mm512_loadu_si512(L.corr0.data() + jb + 8 * half));
        v = _mm512_sub_epi64(v, rs);
        v = _mm512_add_epi64(v, _mm512_loadu_si512(init));
        _mm512_storeu_si512(orow + 8 * half, v);
      }
    }
  }
  for (int j = jb; j < md; ++j)  // column tail (md % 16): scalar, true values
    for (int r = 0; r < R; ++r) {
      const uint64_t* a = Ab + static_cast<size_t>(r) * kd;
      int64_t s = bias ? bias[j] : out[static_cast<size_t>(r) * md + j];
      for (int k = 0; k < kd; ++k)
        s += (static_cast<int64_t>(static_cast<uint32_t>(a[k])) -
              0x80000000ll) *
             L.w[static_cast<size_t>(k) * md + j];
      out[static_cast<size_t>(r) * md + j] = s;
    }
}
#else
// R-row panel of the exact GEMM for AVX512F-only hosts: int32 activations
// (stored in qword scratch) x int16 weights via vpmuldq (signed 32x32->64)
// on the even/odd 32-bit lanes, int64 adds. Products fit 2^46 and sums
// 2^57+bias — bit-identical to gemm_scalar when to_biased accepted.
template <int R>
void gemm_panel_muldq(const uint64_t* Ab, int kd, const QLayer& L,
                      const int64_t* /*rowsum*/, const int64_t* bias,
                      int64_t* out) {
  const int md = L.md;
  const int16_t* W = L.w.data();
  const __m512i idx_lo = _mm512_setr_epi64(0, 8, 1, 9, 2, 10, 3, 11);
  const __m512i idx_hi = _mm512_setr_epi64(4, 12, 5, 13, 6, 14, 7, 15);
  int jb = 0;
  for (; jb + 16 <= md; jb += 16) {
    __m512i ae[R], ao[R];
    for (int r = 0; r < R; ++r) {
      ae[r] = _mm512_setzero_si512();
      ao[r] = _mm512_setzero_si512();
    }
    const int16_t* wp = W + jb;
    for (int k = 0; k < kd; ++k, wp += md) {
      const __m512i w = _mm512_cvtepi16_epi32(
          _mm256_loadu_si256(reinterpret_cast<const __m256i*>(wp)));
      const __m512i wo = _mm512_srli_epi64(w, 32);
      for (int r = 0; r < R; ++r) {
        // un-bias on the fly: low 32 bits of (Ab ^ 0x80000000) = true a
        const __m512i av = _mm512_set1_epi32(static_cast<int32_t>(
            static_cast<uint32_t>(Ab[static_cast<size_t>(r) * kd + k]) ^
            0x80000000u));
        ae[r] = _mm512_add_epi64(ae[r], _mm512_mul_epi32(av, w));
        ao[r] = _mm512_add_epi64(ao[r], _mm512_mul_epi32(av, wo));
      }
    }
    for (int r = 0; r < R; ++r) {
      int64_t* orow = out + static_cast<size_t>(r) * md + jb;
      const int64_t* init = bias ? bias + jb : orow;
      const __m512i lo = _mm512_permutex2var_epi64(ae[r], idx_lo, ao[r]);
      const __m512i hi = _mm512_permutex2var_epi64(ae[r], idx_hi, ao[r]);
      const __m512i i0 = _mm512_loadu_si512(init);
      const __m512i i1 = _mm512_loadu_si512(init + 8);
      _mm512_storeu_si512(orow, _mm512_add_epi64(i0, lo));
      _mm512_storeu_si512(orow + 8, _mm512_add_epi64(i1, hi));
    }
  }
  for (int j = jb; j < md; ++j)  // column tail (md % 16)
    for (int r = 0; r < R; ++r) {
      const uint64_t* a = Ab + static_cast<size_t>(r) * kd;
      int64_t s = bias ? bias[j] : out[static_cast<size_t>(r) * md + j];
      for (int k = 0; k < kd; ++k)
        s += (static_cast<int64_t>(static_cast<uint32_t>(a[k])) -
              0x80000000ll) *
             W[static_cast<size_t>(k) * md + j];
      out[static_cast<size_t>(r) * md + j] = s;
    }
}
#endif  // __AVX512IFMA__
#endif  // NIC_PORT_AVX512

// Exact GEMM with runtime dispatch. n_pad must be a multiple of 4 (caller
// zero-pads activation rows); a_scr holds n_pad*kd qwords, rowsum_scr n_pad
// entries. Results are identical on every path — dispatch never affects
// the stream.
void gemm_exact(const int64_t* A, int n_pad, const QLayer& L,
                const int64_t* bias, uint64_t* a_scr, int64_t* rowsum_scr,
                int64_t* out) {
#ifdef NIC_PORT_AVX512
  if (use_avx512() && to_biased(A, n_pad, L.kd, a_scr, rowsum_scr)) {
#ifdef __AVX512IFMA__
    constexpr auto panel8 = gemm_panel_ifma<8>;
    constexpr auto panel4 = gemm_panel_ifma<4>;
#else
    constexpr auto panel8 = gemm_panel_muldq<8>;
    constexpr auto panel4 = gemm_panel_muldq<4>;
#endif
    int p = 0;
    for (; p + 8 <= n_pad; p += 8)
      panel8(a_scr + static_cast<size_t>(p) * L.kd, L.kd, L, rowsum_scr + p,
             bias, out + static_cast<size_t>(p) * L.md);
    if (p < n_pad)
      panel4(a_scr + static_cast<size_t>(p) * L.kd, L.kd, L, rowsum_scr + p,
             bias, out + static_cast<size_t>(p) * L.md);
    return;
  }
#else
  (void)a_scr;
  (void)rowsum_scr;
#endif
  gemm_scalar(A, n_pad, L.w.data(), bias, L.kd, L.md, out);
}

bool prof_on() {
  static const bool v = std::getenv("NIC_ARPORT_PROFILE") != nullptr;
  return v;
}

double now_s() {
  return std::chrono::duration<double>(
             std::chrono::steady_clock::now().time_since_epoch())
      .count();
}

struct PortNets {
  int M, K, phi_dim, hidden, out_dim, n_bins;
  QLayer ctx, ep1_phi, ep2, ep3;  // ep1_phi: bias zero, sw shared with psi half
  std::vector<int64_t> sigma_thr, sigma_fix, sigma2_fix, sigma_R;
  std::vector<int32_t> tables_cat;
  std::vector<int64_t> table_off, table_len;
  std::vector<int64_t> exp_lut;
  int exp_lut_size;
};

struct SymModel {
  int c, R, nsym;
  uint32_t cum[512];
};

// Mirror of portable.py build_symbol_model. comps: per component
// (mu_fix, bin, wfix), K entries each.
void build_model(const PortNets& net, const int64_t* mu_fix,
                 const int64_t* bins, const int64_t* wfix, SymModel* m) {
  const int K = net.K;
  int64_t c, R;
  if (K == 1) {
    c = rsr(mu_fix[0], kF);
    R = std::max<int64_t>(kPortRMin, net.sigma_R[bins[0]]);
  } else {
    int64_t mean_acc = 0, m2_acc = 0;
    for (int k = 0; k < K; ++k) {
      mean_acc += wfix[k] * mu_fix[k];
      m2_acc += wfix[k] * (net.sigma2_fix[bins[k]] + mu_fix[k] * mu_fix[k]);
    }
    const int64_t mean_fix = rsr(mean_acc, 16);
    const int64_t m2_fix = rsr(m2_acc, 16);
    int64_t var_fix = m2_fix - mean_fix * mean_fix;
    if (var_fix < 1) var_fix = 1;
    const int64_t std_fix =
        static_cast<int64_t>(isqrt_u64(static_cast<uint64_t>(var_fix)));
    c = rsr(mean_fix, kF);
    R = (6 * std_fix + (int64_t{1} << kF) - 1) >> kF;
    R = std::min<int64_t>(254, std::max<int64_t>(kPortRMin, R + 2));
  }
  const int nsym = static_cast<int>(2 * R + 2);
  const int n_edges = nsym;

  int64_t edge_acc[512];
  std::fill(edge_acc, edge_acc + n_edges, 0);
  const int64_t base = -((R << kSub) + 32);
  int64_t wsum = 0;
  for (int k = 0; k < K; ++k) {
    const int64_t mu_idx = rsr(mu_fix[k], kF - kSub);
    const int64_t mu_sub = mu_idx - (c << kSub);
    const int64_t bin = bins[k];
    const int32_t* tab = net.tables_cat.data() + net.table_off[bin];
    const int64_t tlen = net.table_len[bin];
    const int64_t ext = (tlen - 1) / 2;
    const int64_t w = wfix[k];
    wsum += w;
    // arg(e) = (e << kSub) - t increases with e; edges whose arg clamps to
    // a table endpoint contribute the constant w*tab[0] / w*tab[tlen-1].
    // Evaluate only the in-table span — with the wide kPortRMin window the
    // clamped spans dominate for sharp components, and this is exactly
    // equal to clamping every edge (same adds, same order per edge).
    const int64_t t = mu_sub - base - ext;
    // e_lo: first e with arg(e) >= 1  <=>  (e << kSub) >= t + 1
    int64_t u0 = t + 1;
    int64_t e_lo = (u0 <= 0) ? 0 : ((u0 + (1 << kSub) - 1) >> kSub);
    if (e_lo > n_edges) e_lo = n_edges;
    // e_hi: first e with arg(e) >= tlen - 1  <=>  (e << kSub) >= tlen-1 + t
    int64_t u1 = tlen - 1 + t;
    int64_t e_hi = (u1 <= 0) ? 0 : ((u1 + (1 << kSub) - 1) >> kSub);
    if (e_hi < e_lo) e_hi = e_lo;
    if (e_hi > n_edges) e_hi = n_edges;
    const int64_t w_lo = w * tab[0];
    const int64_t w_hi = w * tab[tlen - 1];
    for (int64_t e = 0; e < e_lo; ++e) edge_acc[e] += w_lo;
    for (int64_t e = e_lo; e < e_hi; ++e)
      edge_acc[e] += w * tab[(e << kSub) - t];
    for (int64_t e = e_hi; e < n_edges; ++e) edge_acc[e] += w_hi;
  }
  int64_t pmf[512];
  for (int d = 0; d < nsym - 1; ++d) {
    int64_t p = edge_acc[d + 1] - edge_acc[d];
    pmf[d] = p > 0 ? p : 0;
  }
  int64_t esc = edge_acc[0] + ((wsum << nic::kProbBits) - edge_acc[n_edges - 1]);
  if (esc < 0) esc = 0;
  pmf[nsym - 1] = esc;

  const int64_t budget = nic::kProbScale - nsym;
  uint32_t freq[512];
  int64_t acc = 0;
  int argmax = 0;
  int64_t pmax = -1;
  for (int j = 0; j < nsym; ++j) {
    const int64_t f = 1 + ((pmf[j] * budget) >> 32);
    freq[j] = static_cast<uint32_t>(f);
    acc += f;
    if (pmf[j] > pmax) {  // strict: first max, matching numpy argmax
      pmax = pmf[j];
      argmax = j;
    }
  }
  freq[argmax] = static_cast<uint32_t>(
      static_cast<int64_t>(freq[argmax]) +
      (static_cast<int64_t>(nic::kProbScale) - acc));
  m->c = static_cast<int>(c);
  m->R = static_cast<int>(R);
  m->nsym = nsym;
  m->cum[0] = 0;
  for (int j = 0; j < nsym; ++j) m->cum[j + 1] = m->cum[j] + freq[j];
}

struct PScratch {
  const PortNets& net;
  int H, W, nmax, nmax_pad;
  std::vector<int64_t> y_pad;  // (H+4, W+4, M) at F=12
  std::vector<int64_t> A, phi, h1, h2, h3;
  std::vector<uint64_t> a_scr;  // biased-activation scratch for gemm_exact
  std::vector<int64_t> rowsum_scr;
  std::vector<int> wave_i, wave_j;
  double t_gemm = 0;  // wave_params seconds (NIC_ARPORT_PROFILE)

  PScratch(const PortNets& n, int h, int w, int nmax_override = 0)
      : net(n), H(h), W(w) {
    nmax = nmax_override > 0 ? nmax_override : std::min((W + 2) / 3, H);
    nmax_pad = (nmax + 3) & ~3;
    y_pad.assign(static_cast<size_t>(H + 4) * (W + 4) * net.M, 0);
    A.resize(static_cast<size_t>(nmax_pad) * 12 * net.M);
    phi.resize(static_cast<size_t>(nmax_pad) * net.phi_dim);
    h1.resize(static_cast<size_t>(nmax_pad) * net.hidden);
    h2.resize(static_cast<size_t>(nmax_pad) * net.hidden);
    h3.resize(static_cast<size_t>(nmax_pad) * net.out_dim);
    a_scr.resize(static_cast<size_t>(nmax_pad) *
                 std::max(12 * net.M, std::max(net.phi_dim, net.hidden)));
    rowsum_scr.resize(nmax_pad);
    wave_i.resize(nmax);
    wave_j.resize(nmax);
  }

  int64_t* pad_at(int i, int j) {
    return &y_pad[(static_cast<size_t>(i) * (W + 4) + j) * net.M];
  }

  int collect_wave(int t) {
    int n = 0;
    int i_lo = (t - W + 1 + 2) / 3;
    if (i_lo < 0) i_lo = 0;
    int i_hi = std::min(t / 3, H - 1);
    for (int i = i_lo; i <= i_hi; ++i) {
      int j = t - 3 * i;
      if (j < 0 || j >= W) continue;
      wave_i[n] = i;
      wave_j[n] = j;
      ++n;
    }
    return n;
  }

  // Gather + full GEMM stack; p_acc: (H*W, hidden) int64 accumulators.
  // Rows [n, n_pad) are zero-filled so the panel kernel can run whole
  // 8-row blocks; their outputs are deterministic and never read.
  void wave_params(int n, const int64_t* p_acc) {
    const double t0 = prof_on() ? now_s() : 0;
    const int M = net.M;
    const int n_pad = (n + 3) & ~3;
    for (int p = 0; p < n; ++p) {
      int64_t* dst = &A[static_cast<size_t>(p) * 12 * M];
      const int i = wave_i[p], j = wave_j[p];
      for (int r = 0; r < 2; ++r)
        std::memcpy(dst + r * 5 * M, pad_at(i + r, j),
                    5 * M * sizeof(int64_t));
      std::memcpy(dst + 10 * M, pad_at(i + 2, j), 2 * M * sizeof(int64_t));
    }
    for (int p = n; p < n_pad; ++p)
      std::memset(&A[static_cast<size_t>(p) * 12 * M], 0,
                  12 * M * sizeof(int64_t));
    gemm_exact(A.data(), n_pad, net.ctx, net.ctx.b.data(), a_scr.data(),
               rowsum_scr.data(), phi.data());
    for (size_t i = 0; i < static_cast<size_t>(n_pad) * net.phi_dim; ++i)
      phi[i] = rsr(phi[i], net.ctx.sw);
    // ep1: phi half accumulates on top of the caller-provided psi half
    for (int p = 0; p < n; ++p)
      std::memcpy(&h1[static_cast<size_t>(p) * net.hidden],
                  p_acc + (static_cast<size_t>(wave_i[p]) * W + wave_j[p]) *
                              net.hidden,
                  net.hidden * sizeof(int64_t));
    for (int p = n; p < n_pad; ++p)
      std::memset(&h1[static_cast<size_t>(p) * net.hidden], 0,
                  net.hidden * sizeof(int64_t));
    gemm_exact(phi.data(), n_pad, net.ep1_phi, nullptr, a_scr.data(),
               rowsum_scr.data(), h1.data());
    ep_tail(n_pad);
    if (prof_on()) t_gemm += now_s() - t0;
  }

  // Shared MLP tail: layer-1 accumulators in h1 -> raw h3 (F_BITS).
  void ep_tail(int n_pad) {
    for (size_t i = 0; i < static_cast<size_t>(n_pad) * net.hidden; ++i)
      h1[i] = lrelu1(rsr(h1[i], net.ep1_phi.sw));
    gemm_exact(h1.data(), n_pad, net.ep2, net.ep2.b.data(), a_scr.data(),
               rowsum_scr.data(), h2.data());
    for (size_t i = 0; i < static_cast<size_t>(n_pad) * net.hidden; ++i)
      h2[i] = lrelu1(rsr(h2[i], net.ep2.sw));
    gemm_exact(h2.data(), n_pad, net.ep3, net.ep3.b.data(), a_scr.data(),
               rowsum_scr.data(), h3.data());
    for (size_t i = 0; i < static_cast<size_t>(n_pad) * net.out_dim; ++i)
      h3[i] = rsr(h3[i], net.ep3.sw);
  }

  void load_pacc(int n, const int64_t* p_acc) {
    const int n_pad = (n + 3) & ~3;
    for (int p = 0; p < n; ++p)
      std::memcpy(&h1[static_cast<size_t>(p) * net.hidden],
                  p_acc + (static_cast<size_t>(wave_i[p]) * W + wave_j[p]) *
                              net.hidden,
                  net.hidden * sizeof(int64_t));
    for (int p = n; p < n_pad; ++p)
      std::memset(&h1[static_cast<size_t>(p) * net.hidden], 0,
                  net.hidden * sizeof(int64_t));
  }

  // Checkerboard ANCHOR pass: context is exactly zero, so h1 = p_acc
  // (adding a zero phi product is a no-op in exact integer arithmetic —
  // see portable.py params_from_acc).
  void cb_anchor_params(int n, const int64_t* p_acc) {
    const double t0 = prof_on() ? now_s() : 0;
    load_pacc(n, p_acc);
    ep_tail((n + 3) & ~3);
    if (prof_on()) t_gemm += now_s() - t0;
  }

  // Checkerboard NON-ANCHOR pass: gather the 12 odd-parity taps (all
  // anchors) from the anchor-filled pad, then the same GEMM stack as the
  // wavefront. Tap order = models/checkerboard.py CB_CTX_POSITIONS.
  void cb_nonanchor_params(int n, const int64_t* p_acc) {
    static const int kCbTaps[12][2] = {{0, 1}, {0, 3}, {1, 0}, {1, 2},
                                       {1, 4}, {2, 1}, {2, 3}, {3, 0},
                                       {3, 2}, {3, 4}, {4, 1}, {4, 3}};
    const double t0 = prof_on() ? now_s() : 0;
    const int M = net.M;
    const int n_pad = (n + 3) & ~3;
    for (int p = 0; p < n; ++p) {
      int64_t* dst = &A[static_cast<size_t>(p) * 12 * M];
      const int i = wave_i[p], j = wave_j[p];
      for (int t = 0; t < 12; ++t)
        std::memcpy(dst + t * M, pad_at(i + kCbTaps[t][0], j + kCbTaps[t][1]),
                    M * sizeof(int64_t));
    }
    for (int p = n; p < n_pad; ++p)
      std::memset(&A[static_cast<size_t>(p) * 12 * M], 0,
                  12 * M * sizeof(int64_t));
    gemm_exact(A.data(), n_pad, net.ctx, net.ctx.b.data(), a_scr.data(),
               rowsum_scr.data(), phi.data());
    for (size_t i = 0; i < static_cast<size_t>(n_pad) * net.phi_dim; ++i)
      phi[i] = rsr(phi[i], net.ctx.sw);
    load_pacc(n, p_acc);
    gemm_exact(phi.data(), n_pad, net.ep1_phi, nullptr, a_scr.data(),
               rowsum_scr.data(), h1.data());
    ep_tail(n_pad);
    if (prof_on()) t_gemm += now_s() - t0;
  }

  // One pixel's h3 row -> per-channel (mu_fix, bin, wfix), coder layout.
  void pixel_models(int p, int64_t* mu, int64_t* bins, int64_t* wfix) const {
    const int M = net.M, K = net.K;
    const int64_t* row = &h3[static_cast<size_t>(p) * net.out_dim];
    if (K == 1) {
      for (int m = 0; m < M; ++m) {
        mu[m] = row[m];
        const int64_t s = row[M + m];
        bins[m] = std::upper_bound(net.sigma_thr.begin(), net.sigma_thr.end(),
                                   s) -
                  net.sigma_thr.begin();
        wfix[m] = kWScale;
      }
      return;
    }
    const int MK = M * K;
    for (int m = 0; m < M; ++m) {
      const int64_t* a = row + m * K;           // (kind, m, k) layout
      int64_t mx = a[0];
      for (int k = 1; k < K; ++k) mx = std::max(mx, a[k]);
      int64_t e[16], sum = 0;
      for (int k = 0; k < K; ++k) {
        int64_t idx = rsr(mx - a[k], kExpShift);
        if (idx > net.exp_lut_size - 1) idx = net.exp_lut_size - 1;
        e[k] = net.exp_lut[idx];
        sum += e[k];
      }
      int64_t wrem = kWScale;
      int am = 0;
      int64_t emax = -1;
      for (int k = 0; k < K; ++k) {
        const int64_t w = (e[k] << 16) / sum;
        wfix[m * K + k] = w;
        wrem -= w;
        if (e[k] > emax) {  // first max
          emax = e[k];
          am = k;
        }
      }
      wfix[m * K + am] += wrem;
      for (int k = 0; k < K; ++k) {
        mu[m * K + k] = row[MK + m * K + k];
        const int64_t s = row[2 * MK + m * K + k];
        bins[m * K + k] =
            std::upper_bound(net.sigma_thr.begin(), net.sigma_thr.end(), s) -
            net.sigma_thr.begin();
      }
    }
  }
};

// ---------------------------------------------------------------------------
// Native integer hyper-decoder (z_q -> psi), mirroring portable.py's
// _int_conv2d / _int_deconv2d exactly: same geometry, same exact int64
// sums (order-free), same requant/leaky placement — so hyper_forward gives
// bit-identical psi on either implementation.
// ---------------------------------------------------------------------------

struct HLayer {
  int kind;  // 0 conv, 1 deconv
  int kh, kw, cin, cout, stride, pad, opad, sw;
  std::vector<QLayer> taps;   // per (r, c): (cin, cout) GEMM
  std::vector<int64_t> bias;  // (cout,)
};

struct HyperNet {
  std::vector<HLayer> layers;
};

// First output/input index and count for one deconv tap (portable.py _span).
bool dspan(int tap, int lo, int stride, int out_len, int in_len, int* o0,
           int* i0, int* n) {
  int o = lo - tap, i = 0;
  while (o < 0) {
    o += stride;
    ++i;
  }
  if (o >= out_len || i >= in_len) return false;
  *n = std::min((out_len - 1 - o) / stride, in_len - 1 - i) + 1;
  *o0 = o;
  *i0 = i;
  return true;
}

struct HScratch {
  std::vector<int64_t> a, g;  // gathered activations / output rows
  std::vector<uint64_t> a_scr;
  std::vector<int64_t> rowsum;

  void reserve_rows(int n_pad, int kd, int md) {
    a.resize(static_cast<size_t>(n_pad) * kd);
    g.resize(static_cast<size_t>(n_pad) * md);
    a_scr.resize(static_cast<size_t>(n_pad) * kd);
    rowsum.resize(n_pad);
  }
};

// One tap-GEMM over gathered rows; init = bias (first conv tap) or
// accumulate onto the gathered output rows.
void tap_gemm(HScratch& s, int n, const QLayer& tap, const int64_t* bias,
              int64_t* out) {
  const int n_pad = (n + 3) & ~3;
  for (int p = n; p < n_pad; ++p)
    std::memset(&s.a[static_cast<size_t>(p) * tap.kd], 0,
                tap.kd * sizeof(int64_t));
  gemm_exact(s.a.data(), n_pad, tap, bias, s.a_scr.data(), s.rowsum.data(),
             out);
}

void hyper_conv(const HLayer& L, const int64_t* x, int h, int w,
                std::vector<int64_t>& out, int* oh_, int* ow_, HScratch& s) {
  const int p = L.pad, st = L.stride;
  const int hp = h + 2 * p, wp = w + 2 * p;
  std::vector<int64_t> xp(static_cast<size_t>(hp) * wp * L.cin, 0);
  for (int i = 0; i < h; ++i)
    std::memcpy(&xp[(static_cast<size_t>(i + p) * wp + p) * L.cin],
                x + static_cast<size_t>(i) * w * L.cin,
                static_cast<size_t>(w) * L.cin * sizeof(int64_t));
  const int oh = (hp - L.kh) / st + 1, ow = (wp - L.kw) / st + 1;
  const int n = oh * ow;
  const int n_pad = (n + 3) & ~3;
  out.resize(static_cast<size_t>(n_pad) * L.cout);
  s.reserve_rows(n_pad, L.cin, L.cout);
  bool first = true;
  for (int r = 0; r < L.kh; ++r)
    for (int c = 0; c < L.kw; ++c) {
      for (int i = 0; i < oh; ++i)
        for (int j = 0; j < ow; ++j)
          std::memcpy(&s.a[(static_cast<size_t>(i) * ow + j) * L.cin],
                      &xp[(static_cast<size_t>(r + i * st) * wp + c + j * st) *
                          L.cin],
                      L.cin * sizeof(int64_t));
      tap_gemm(s, n, L.taps[r * L.kw + c],
               first ? L.bias.data() : nullptr, out.data());
      first = false;
    }
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < L.cout; ++j)
      out[static_cast<size_t>(i) * L.cout + j] =
          rsr(out[static_cast<size_t>(i) * L.cout + j], L.sw);
  *oh_ = oh;
  *ow_ = ow;
}

void hyper_deconv(const HLayer& L, const int64_t* x, int h, int w,
                  std::vector<int64_t>& out, int* oh_, int* ow_,
                  HScratch& s) {
  const int st = L.stride;
  const int hd = (h - 1) * st + 1, wd = (w - 1) * st + 1;
  // per-axis pads (kh vs kw) so non-square kernels stay exact
  const int lo_r = L.kh - 1 - L.pad, lo_c = L.kw - 1 - L.pad;
  const int oh = hd + 2 * lo_r + L.opad - L.kh + 1;
  const int ow = wd + 2 * lo_c + L.opad - L.kw + 1;
  out.assign(static_cast<size_t>(oh) * ow * L.cout, 0);
  for (int i = 0; i < oh * ow; ++i)
    std::memcpy(&out[static_cast<size_t>(i) * L.cout], L.bias.data(),
                L.cout * sizeof(int64_t));
  for (int r = 0; r < L.kh; ++r) {
    int oi0, ii0, nr;
    if (!dspan(r, lo_r, st, oh, h, &oi0, &ii0, &nr)) continue;
    for (int c = 0; c < L.kw; ++c) {
      int oj0, jj0, nc;
      if (!dspan(c, lo_c, st, ow, w, &oj0, &jj0, &nc)) continue;
      const int n = nr * nc;
      s.reserve_rows((n + 3) & ~3, L.cin, L.cout);
      for (int a = 0; a < nr; ++a)
        for (int b = 0; b < nc; ++b) {
          std::memcpy(&s.a[(static_cast<size_t>(a) * nc + b) * L.cin],
                      &x[(static_cast<size_t>(ii0 + a) * w + jj0 + b) * L.cin],
                      L.cin * sizeof(int64_t));
          std::memcpy(
              &s.g[(static_cast<size_t>(a) * nc + b) * L.cout],
              &out[(static_cast<size_t>(oi0 + a * st) * ow + oj0 + b * st) *
                   L.cout],
              L.cout * sizeof(int64_t));
        }
      tap_gemm(s, n, L.taps[r * L.kw + c], nullptr, s.g.data());
      for (int a = 0; a < nr; ++a)
        for (int b = 0; b < nc; ++b)
          std::memcpy(
              &out[(static_cast<size_t>(oi0 + a * st) * ow + oj0 + b * st) *
                   L.cout],
              &s.g[(static_cast<size_t>(a) * nc + b) * L.cout],
              L.cout * sizeof(int64_t));
    }
  }
  for (size_t i = 0; i < static_cast<size_t>(oh) * ow * L.cout; ++i)
    out[i] = rsr(out[i], L.sw);
  *oh_ = oh;
  *ow_ = ow;
}

}  // namespace

extern "C" {

void* arport_create(int M, int K, int phi_dim, int hidden, int out_dim,
                    int n_bins, const int16_t* ctx_w, const int64_t* ctx_b,
                    int ctx_sw, const int16_t* ep1_phi_w, int ep1_sw,
                    const int16_t* ep2_w, const int64_t* ep2_b, int ep2_sw,
                    const int16_t* ep3_w, const int64_t* ep3_b, int ep3_sw,
                    const int64_t* sigma_thr, const int64_t* sigma_fix,
                    const int64_t* sigma2_fix, const int64_t* sigma_R,
                    const int32_t* tables_cat, int64_t tables_total,
                    const int64_t* table_off, const int64_t* table_len,
                    const int64_t* exp_lut, int exp_lut_size) {
  // PortableCard.__init__ enforces these; reject here too so a card that
  // bypassed Python validation can't overflow the fixed K-scratch (16) or
  // symbol-edge (2*254+2) buffers.
  if (K < 1 || K > 16) return nullptr;
  if (M < 1 || M > 330) return nullptr;  // = portable.py M_MAX (GEMM bound)
  for (int b = 0; b < n_bins; ++b)
    if (sigma_R[b] < 0 || sigma_R[b] > 254) return nullptr;
  PortNets* n = new PortNets();
  n->M = M;
  n->K = K;
  n->phi_dim = phi_dim;
  n->hidden = hidden;
  n->out_dim = out_dim;
  n->n_bins = n_bins;
  auto fill = [](QLayer& L, const int16_t* w, const int64_t* b, int sw,
                 int kd, int md) {
    L.w.assign(w, w + static_cast<size_t>(kd) * md);
    if (b)
      L.b.assign(b, b + md);
    else
      L.b.assign(md, 0);
    L.sw = sw;
    L.kd = kd;
    L.md = md;
    L.finalize();
  };
  fill(n->ctx, ctx_w, ctx_b, ctx_sw, 12 * M, phi_dim);
  fill(n->ep1_phi, ep1_phi_w, nullptr, ep1_sw, phi_dim, hidden);
  fill(n->ep2, ep2_w, ep2_b, ep2_sw, hidden, hidden);
  fill(n->ep3, ep3_w, ep3_b, ep3_sw, hidden, out_dim);
  n->sigma_thr.assign(sigma_thr, sigma_thr + n_bins - 1);
  n->sigma_fix.assign(sigma_fix, sigma_fix + n_bins);
  n->sigma2_fix.assign(sigma2_fix, sigma2_fix + n_bins);
  n->sigma_R.assign(sigma_R, sigma_R + n_bins);
  n->tables_cat.assign(tables_cat, tables_cat + tables_total);
  n->table_off.assign(table_off, table_off + n_bins);
  n->table_len.assign(table_len, table_len + n_bins);
  n->exp_lut.assign(exp_lut, exp_lut + exp_lut_size);
  n->exp_lut_size = exp_lut_size;
  return n;
}

void arport_destroy(void* h) { delete static_cast<PortNets*>(h); }

// Build a native hyper-decoder from the card's quantized layer stack.
// meta: (n_layers, 9) int64 rows [kind, kh, kw, cin, cout, stride, pad,
// opad, sw]; w_cat/b_cat: concatenated HWIO int16 kernels / int64 biases
// with per-layer offsets.
void* arport_hyper_create(int n_layers, const int64_t* meta,
                          const int16_t* w_cat, const int64_t* w_off,
                          const int64_t* b_cat, const int64_t* b_off) {
  HyperNet* net = new HyperNet();
  net->layers.resize(n_layers);
  for (int l = 0; l < n_layers; ++l) {
    HLayer& L = net->layers[l];
    const int64_t* m = meta + l * 9;
    L.kind = static_cast<int>(m[0]);
    L.kh = static_cast<int>(m[1]);
    L.kw = static_cast<int>(m[2]);
    L.cin = static_cast<int>(m[3]);
    L.cout = static_cast<int>(m[4]);
    L.stride = static_cast<int>(m[5]);
    L.pad = static_cast<int>(m[6]);
    L.opad = static_cast<int>(m[7]);
    L.sw = static_cast<int>(m[8]);
    const int16_t* w = w_cat + w_off[l];
    L.taps.resize(L.kh * L.kw);
    for (int t = 0; t < L.kh * L.kw; ++t) {
      QLayer& q = L.taps[t];
      const int16_t* wt = w + static_cast<size_t>(t) * L.cin * L.cout;
      q.w.assign(wt, wt + static_cast<size_t>(L.cin) * L.cout);
      q.b.assign(L.cout, 0);
      q.kd = L.cin;
      q.md = L.cout;
      q.finalize();
    }
    L.bias.assign(b_cat + b_off[l], b_cat + b_off[l] + L.cout);
  }
  return net;
}

void arport_hyper_destroy(void* h) { delete static_cast<HyperNet*>(h); }

// z: (hz, wz, cin0) int32 integer latents. Writes psi (oh, ow, cout_last)
// int64 at F_BITS into out; returns the element count, or -1 if it would
// exceed cap. Leaky-ReLU between layers, none after the last — exactly
// PortableCard.hyper_forward.
int64_t arport_hyper_run(void* handle, const int32_t* z, int hz, int wz,
                         int64_t* out, int64_t cap) {
  const HyperNet& net = *static_cast<HyperNet*>(handle);
  const int n_layers = static_cast<int>(net.layers.size());
  std::vector<int64_t> cur(static_cast<size_t>(hz) * wz *
                           net.layers[0].cin);
  for (size_t i = 0; i < cur.size(); ++i)
    cur[i] = static_cast<int64_t>(z[i]) << kF;
  int h = hz, w = wz;
  HScratch s;
  std::vector<int64_t> nxt;
  for (int l = 0; l < n_layers; ++l) {
    const HLayer& L = net.layers[l];
    int oh = 0, ow = 0;
    if (L.kind == 0)
      hyper_conv(L, cur.data(), h, w, nxt, &oh, &ow, s);
    else
      hyper_deconv(L, cur.data(), h, w, nxt, &oh, &ow, s);
    h = oh;
    w = ow;
    if (l < n_layers - 1) {
      const size_t cnt = static_cast<size_t>(h) * w * L.cout;
      for (size_t i = 0; i < cnt; ++i) nxt[i] = lrelu1(nxt[i]);
    }
    cur.swap(nxt);
  }
  const int64_t cnt = static_cast<int64_t>(h) * w * net.layers.back().cout;
  if (cnt > cap) return -1;
  std::memcpy(out, cur.data(), static_cast<size_t>(cnt) * sizeof(int64_t));
  return cnt;
}

// p_acc (n, hidden) = psi_fix (n, psi_dim) @ W + bias: the ep-layer-1
// psi-half accumulators, exact int64 through the same kernel as the
// wavefront GEMMs (bit-identical to the numpy float64-BLAS fast path,
// which is likewise exact).
void arport_psi(const int16_t* w, const int64_t* b, int kd, int md,
                const int64_t* psi, int n, int64_t* out) {
  QLayer L;
  L.w.assign(w, w + static_cast<size_t>(kd) * md);
  L.b.assign(b, b + md);
  L.kd = kd;
  L.md = md;
  L.finalize();
  const int n_main = n & ~3;
  if (n_main) {
    std::vector<uint64_t> a_scr(static_cast<size_t>(n_main) * kd);
    std::vector<int64_t> rowsum(n_main);
    gemm_exact(psi, n_main, L, b, a_scr.data(), rowsum.data(), out);
  }
  if (n_main < n)
    gemm_scalar(psi + static_cast<size_t>(n_main) * kd, n - n_main, w, b,
                kd, md, out + static_cast<size_t>(n_main) * md);
}

// y_q: (H, W, M) int32 latents; p_acc: (H*W, hidden) int64 psi-half
// accumulators. Returns stream length, or -1 on overflow.
int arport_encode(void* handle, const int32_t* y_q, const int64_t* p_acc,
                  int H, int W, uint8_t* out, int cap) {
  const PortNets& net = *static_cast<PortNets*>(handle);
  const int M = net.M, K = net.K;
  PScratch sc(net, H, W);
  for (int i = 0; i < H; ++i)
    for (int j = 0; j < W; ++j) {
      int64_t* dst = sc.pad_at(i + 2, j + 2);
      const int32_t* src = y_q + (static_cast<size_t>(i) * W + j) * M;
      for (int m = 0; m < M; ++m)
        dst[m] = static_cast<int64_t>(src[m]) << kF;
    }

  const size_t n_sym = static_cast<size_t>(H) * W * M;
  std::vector<int32_t> sym(n_sym);
  std::vector<int64_t> mu(n_sym * K), bins(n_sym * K), wfix(n_sym * K);
  const int t_max = 3 * (H - 1) + W;
  size_t s = 0;
  for (int t = 0; t < t_max; ++t) {
    const int n = sc.collect_wave(t);
    if (n == 0) continue;
    sc.wave_params(n, p_acc);
    for (int p = 0; p < n; ++p) {
      sc.pixel_models(p, &mu[s * K], &bins[s * K], &wfix[s * K]);
      const int32_t* yrow =
          y_q + (static_cast<size_t>(sc.wave_i[p]) * W + sc.wave_j[p]) * M;
      for (int m = 0; m < M; ++m) sym[s + m] = yrow[m];
      s += M;
    }
  }

  const double t1 = prof_on() ? now_s() : 0;
  Encoder enc;
  enc.bytes.reserve(n_sym * 2 + 16);
  SymModel sm;
  for (int64_t i = static_cast<int64_t>(n_sym) - 1; i >= 0; --i) {
    build_model(net, &mu[i * K], &bins[i * K], &wfix[i * K], &sm);
    const int d = sym[i] - sm.c;
    if (d >= -sm.R && d <= sm.R) {
      const int j = d + sm.R;
      enc.put(sm.cum[j], sm.cum[j + 1] - sm.cum[j]);
    } else {
      nic::put_escape_value(enc, sym[i]);
      const int j = sm.nsym - 1;
      enc.put(sm.cum[j], sm.cum[j + 1] - sm.cum[j]);
    }
  }
  if (prof_on())
    std::fprintf(stderr,
                 "[arport_encode] wave_params %.1f ms, model+rans %.1f ms\n",
                 sc.t_gemm * 1e3, (now_s() - t1) * 1e3);
  return enc.flush(out, cap);
}

// Returns 0, or -1 on corrupt/truncated stream.
int arport_decode(void* handle, const uint8_t* buf, int len,
                  const int64_t* p_acc, int H, int W, int32_t* y_out) {
  const PortNets& net = *static_cast<PortNets*>(handle);
  const int M = net.M, K = net.K;
  PScratch sc(net, H, W);
  Decoder dec;
  dec.init(buf, len);
  std::vector<int64_t> mu(static_cast<size_t>(M) * K),
      bins(static_cast<size_t>(M) * K), wfix(static_cast<size_t>(M) * K);
  SymModel sm;
  const int t_max = 3 * (H - 1) + W;
  for (int t = 0; t < t_max; ++t) {
    const int n = sc.collect_wave(t);
    if (n == 0) continue;
    sc.wave_params(n, p_acc);
    for (int p = 0; p < n; ++p) {
      const int i = sc.wave_i[p], j = sc.wave_j[p];
      int32_t* dst = y_out + (static_cast<size_t>(i) * W + j) * M;
      int64_t* pad = sc.pad_at(i + 2, j + 2);
      sc.pixel_models(p, mu.data(), bins.data(), wfix.data());
      for (int m = 0; m < M; ++m) {
        build_model(net, &mu[m * K], &bins[m * K], &wfix[m * K], &sm);
        const uint32_t cf = dec.peek();
        const int jj = cdf_find(sm.cum, sm.nsym, cf);
        dec.advance(sm.cum[jj], sm.cum[jj + 1] - sm.cum[jj]);
        int32_t v;
        if (jj == sm.nsym - 1) {
          v = nic::get_escape_value(dec);
          // Spec bound (portable.py Y_ABS_MAX): legit latents are int16-
          // sized; an adversarial escape near +-2^31 would overflow the
          // int64 context-GEMM accumulators (UB). Both implementations
          // reject identically.
          if (v > kYAbsMax || v < -kYAbsMax) return -1;
        } else {
          v = sm.c + (jj - sm.R);
        }
        dst[m] = v;
        pad[m] = static_cast<int64_t>(v) << kF;
      }
    }
  }
  if (prof_on())
    std::fprintf(stderr, "[arport_decode] wave_params %.1f ms\n",
                 sc.t_gemm * 1e3);
  return dec.ok() ? 0 : -1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Checkerboard two-pass portable codec (mirror of portable.py
// portable_cb_encode / portable_cb_decode): anchors ((i+j) even, row-major)
// code from the hyperprior alone (context exactly zero); non-anchors from
// the 12-tap integer context GEMM over the decoded anchors. Same symbol
// model, escape and rANS conventions as the wavefront functions above.
// ---------------------------------------------------------------------------

namespace {

constexpr int kCbBlock = 256;  // pixels per GEMM block (scratch bound)

// Row-major (i, j) lists for one parity. parity 0 = anchors.
int cb_collect(int H, int W, int parity, int start, int count, int* out_i,
               int* out_j) {
  // start counts pixels of this parity already consumed.
  int n = 0, seen = 0;
  for (int i = 0; i < H && n < count; ++i) {
    int j0 = ((i % 2) == parity) ? 0 : 1;
    for (int j = j0; j < W && n < count; j += 2) {
      if (seen++ < start) continue;
      out_i[n] = i;
      out_j[n] = j;
      ++n;
    }
  }
  return n;
}

inline int cb_count(int H, int W, int parity) {
  const int total = H * W;
  return parity == 0 ? (total + 1) / 2 : total / 2;
}

}  // namespace

extern "C" {

// y_q: (H, W, M) int32 latents; p_acc: (H*W, hidden). Returns stream
// length, or -1 on overflow.
int arport_encode_cb(void* handle, const int32_t* y_q, const int64_t* p_acc,
                     int H, int W, uint8_t* out, int cap) {
  const PortNets& net = *static_cast<PortNets*>(handle);
  const int M = net.M, K = net.K;
  PScratch sc(net, H, W, kCbBlock);
  // the pad holds ANCHOR values only — decode-side parity (it never knows
  // non-anchors when pass-2 params are derived)
  for (int i = 0; i < H; ++i)
    for (int j = (i % 2 == 0) ? 0 : 1; j < W; j += 2) {
      int64_t* dst = sc.pad_at(i + 2, j + 2);
      const int32_t* src = y_q + (static_cast<size_t>(i) * W + j) * M;
      for (int m = 0; m < M; ++m)
        dst[m] = static_cast<int64_t>(src[m]) << kF;
    }

  const size_t n_sym = static_cast<size_t>(H) * W * M;
  std::vector<int32_t> sym(n_sym);
  std::vector<int64_t> mu(n_sym * K), bins(n_sym * K), wfix(n_sym * K);
  size_t s = 0;
  for (int parity = 0; parity < 2; ++parity) {
    const int total = cb_count(H, W, parity);
    for (int start = 0; start < total; start += kCbBlock) {
      const int n = cb_collect(H, W, parity, start,
                               std::min(kCbBlock, total - start),
                               sc.wave_i.data(), sc.wave_j.data());
      if (parity == 0)
        sc.cb_anchor_params(n, p_acc);
      else
        sc.cb_nonanchor_params(n, p_acc);
      for (int p = 0; p < n; ++p) {
        sc.pixel_models(p, &mu[s * K], &bins[s * K], &wfix[s * K]);
        const int32_t* yrow =
            y_q + (static_cast<size_t>(sc.wave_i[p]) * W + sc.wave_j[p]) * M;
        for (int m = 0; m < M; ++m) sym[s + m] = yrow[m];
        s += M;
      }
    }
  }

  Encoder enc;
  enc.bytes.reserve(n_sym * 2 + 16);
  SymModel sm;
  for (int64_t i = static_cast<int64_t>(n_sym) - 1; i >= 0; --i) {
    build_model(net, &mu[i * K], &bins[i * K], &wfix[i * K], &sm);
    const int d = sym[i] - sm.c;
    if (d >= -sm.R && d <= sm.R) {
      const int j = d + sm.R;
      enc.put(sm.cum[j], sm.cum[j + 1] - sm.cum[j]);
    } else {
      nic::put_escape_value(enc, sym[i]);
      const int j = sm.nsym - 1;
      enc.put(sm.cum[j], sm.cum[j + 1] - sm.cum[j]);
    }
  }
  return enc.flush(out, cap);
}

// Returns 0, or -1 on corrupt/truncated stream.
int arport_decode_cb(void* handle, const uint8_t* buf, int len,
                     const int64_t* p_acc, int H, int W, int32_t* y_out) {
  const PortNets& net = *static_cast<PortNets*>(handle);
  const int M = net.M, K = net.K;
  PScratch sc(net, H, W, kCbBlock);
  Decoder dec;
  dec.init(buf, len);
  std::vector<int64_t> mu(static_cast<size_t>(M) * K),
      bins(static_cast<size_t>(M) * K), wfix(static_cast<size_t>(M) * K);
  SymModel sm;
  for (int parity = 0; parity < 2; ++parity) {
    const int total = cb_count(H, W, parity);
    for (int start = 0; start < total; start += kCbBlock) {
      const int n = cb_collect(H, W, parity, start,
                               std::min(kCbBlock, total - start),
                               sc.wave_i.data(), sc.wave_j.data());
      if (parity == 0)
        sc.cb_anchor_params(n, p_acc);
      else
        sc.cb_nonanchor_params(n, p_acc);
      for (int p = 0; p < n; ++p) {
        const int i = sc.wave_i[p], j = sc.wave_j[p];
        int32_t* dst = y_out + (static_cast<size_t>(i) * W + j) * M;
        int64_t* pad = sc.pad_at(i + 2, j + 2);
        sc.pixel_models(p, mu.data(), bins.data(), wfix.data());
        for (int m = 0; m < M; ++m) {
          build_model(net, &mu[m * K], &bins[m * K], &wfix[m * K], &sm);
          const uint32_t cf = dec.peek();
          const int jj = cdf_find(sm.cum, sm.nsym, cf);
          dec.advance(sm.cum[jj], sm.cum[jj + 1] - sm.cum[jj]);
          int32_t v;
          if (jj == sm.nsym - 1) {
            v = nic::get_escape_value(dec);
            if (v > kYAbsMax || v < -kYAbsMax) return -1;
          } else {
            v = sm.c + (jj - sm.R);
          }
          dst[m] = v;
          if (parity == 0) pad[m] = static_cast<int64_t>(v) << kF;
        }
      }
    }
  }
  return dec.ok() ? 0 : -1;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Hyperprior one-pass portable codec (mirror of portable.py
// portable_hp_encode / portable_hp_decode): the family has NO context model
// (models/hyperprior.py), so every position's parameters come from the
// hyperprior accumulators alone (the checkerboard anchor-pass math applied
// to the whole grid) in row-major position order. Same symbol model, escape
// and rANS conventions as the wavefront/checkerboard functions above.
// ---------------------------------------------------------------------------

extern "C" {

// y_q: (H, W, M) int32 latents; p_acc: (H*W, hidden). Returns stream
// length, or -1 on overflow.
int arport_encode_hp(void* handle, const int32_t* y_q, const int64_t* p_acc,
                     int H, int W, uint8_t* out, int cap) {
  const PortNets& net = *static_cast<PortNets*>(handle);
  const int M = net.M, K = net.K;
  PScratch sc(net, H, W, kCbBlock);

  const int total = H * W;
  const size_t n_sym = static_cast<size_t>(total) * M;
  std::vector<int32_t> sym(n_sym);
  std::vector<int64_t> mu(n_sym * K), bins(n_sym * K), wfix(n_sym * K);
  size_t s = 0;
  for (int start = 0; start < total; start += kCbBlock) {
    const int n = std::min(kCbBlock, total - start);
    for (int p = 0; p < n; ++p) {
      sc.wave_i[p] = (start + p) / W;
      sc.wave_j[p] = (start + p) % W;
    }
    sc.cb_anchor_params(n, p_acc);  // context-free params for the block
    for (int p = 0; p < n; ++p) {
      sc.pixel_models(p, &mu[s * K], &bins[s * K], &wfix[s * K]);
      const int32_t* yrow = y_q + static_cast<size_t>(start + p) * M;
      for (int m = 0; m < M; ++m) sym[s + m] = yrow[m];
      s += M;
    }
  }

  Encoder enc;
  enc.bytes.reserve(n_sym * 2 + 16);
  SymModel sm;
  for (int64_t i = static_cast<int64_t>(n_sym) - 1; i >= 0; --i) {
    build_model(net, &mu[i * K], &bins[i * K], &wfix[i * K], &sm);
    const int d = sym[i] - sm.c;
    if (d >= -sm.R && d <= sm.R) {
      const int j = d + sm.R;
      enc.put(sm.cum[j], sm.cum[j + 1] - sm.cum[j]);
    } else {
      nic::put_escape_value(enc, sym[i]);
      const int j = sm.nsym - 1;
      enc.put(sm.cum[j], sm.cum[j + 1] - sm.cum[j]);
    }
  }
  return enc.flush(out, cap);
}

// Returns 0, or -1 on corrupt/truncated stream.
int arport_decode_hp(void* handle, const uint8_t* buf, int len,
                     const int64_t* p_acc, int H, int W, int32_t* y_out) {
  const PortNets& net = *static_cast<PortNets*>(handle);
  const int M = net.M, K = net.K;
  PScratch sc(net, H, W, kCbBlock);
  Decoder dec;
  dec.init(buf, len);
  std::vector<int64_t> mu(static_cast<size_t>(M) * K),
      bins(static_cast<size_t>(M) * K), wfix(static_cast<size_t>(M) * K);
  SymModel sm;
  const int total = H * W;
  for (int start = 0; start < total; start += kCbBlock) {
    const int n = std::min(kCbBlock, total - start);
    for (int p = 0; p < n; ++p) {
      sc.wave_i[p] = (start + p) / W;
      sc.wave_j[p] = (start + p) % W;
    }
    sc.cb_anchor_params(n, p_acc);
    for (int p = 0; p < n; ++p) {
      int32_t* dst = y_out + static_cast<size_t>(start + p) * M;
      sc.pixel_models(p, mu.data(), bins.data(), wfix.data());
      for (int m = 0; m < M; ++m) {
        build_model(net, &mu[m * K], &bins[m * K], &wfix[m * K], &sm);
        const uint32_t cf = dec.peek();
        const int jj = cdf_find(sm.cum, sm.nsym, cf);
        dec.advance(sm.cum[jj], sm.cum[jj + 1] - sm.cum[jj]);
        int32_t v;
        if (jj == sm.nsym - 1) {
          v = nic::get_escape_value(dec);
          if (v > kYAbsMax || v < -kYAbsMax) return -1;
        } else {
          v = sm.c + (jj - sm.R);
        }
        dst[m] = v;
      }
    }
  }
  return dec.ok() ? 0 : -1;
}

}  // extern "C"
