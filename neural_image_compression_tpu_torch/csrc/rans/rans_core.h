// Shared rANS primitives + deterministic Gaussian/GMM symbol models.
//
// Used by both the generic stream coder (rans.cc) and the native
// autoregressive wavefront codec (ar_wavefront.cc). Everything here must be
// bit-deterministic for a fixed input: encode and decode derive each
// symbol's fixed-point CDF by running the SAME code on the SAME floats.
//
// (The reference has no entropy coder at all — rate is analytic,
// RateDistortionLoss.py:13-17; see rans.cc for the full design note.)

#ifndef NIC_RANS_CORE_H_
#define NIC_RANS_CORE_H_

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace nic {

constexpr uint32_t kProbBits = 16;
constexpr uint32_t kProbScale = 1u << kProbBits;
constexpr uint32_t kRansL = 1u << 23;  // lower bound of the state interval

// ---------------------------------------------------------------------------
// rANS primitives
// ---------------------------------------------------------------------------

struct Encoder {
  uint32_t x = kRansL;
  std::vector<uint8_t> bytes;  // emitted backwards; reversed at flush

  inline void put(uint32_t cum, uint32_t freq) {
    uint32_t x_max = ((kRansL >> kProbBits) << 8) * freq;
    while (x >= x_max) {
      bytes.push_back(static_cast<uint8_t>(x & 0xff));
      x >>= 8;
    }
    x = ((x / freq) << kProbBits) + (x % freq) + cum;
  }

  inline void put_raw16(uint32_t v) { put(v, 1); }  // uniform: 16 bits

  // Returns total byte length; writes into out (caller-sized).
  int flush(uint8_t* out, int cap) {
    bytes.push_back(static_cast<uint8_t>(x & 0xff));
    bytes.push_back(static_cast<uint8_t>((x >> 8) & 0xff));
    bytes.push_back(static_cast<uint8_t>((x >> 16) & 0xff));
    bytes.push_back(static_cast<uint8_t>((x >> 24) & 0xff));
    int n = static_cast<int>(bytes.size());
    if (n > cap) return -1;
    for (int i = 0; i < n; ++i) out[i] = bytes[n - 1 - i];
    return n;
  }
};

struct Decoder {
  uint32_t x = 0;
  const uint8_t* buf = nullptr;
  int len = 0;
  int pos = 0;

  void init(const uint8_t* b, int l) {
    buf = b;
    len = l;
    pos = 0;
    x = 0;
    for (int i = 0; i < 4 && pos < len; ++i) x = (x << 8) | buf[pos++];
  }

  inline uint32_t peek() const { return x & (kProbScale - 1); }

  inline void advance(uint32_t cum, uint32_t freq) {
    x = freq * (x >> kProbBits) + (x & (kProbScale - 1)) - cum;
    while (x < kRansL && pos < len) x = (x << 8) | buf[pos++];
  }

  inline uint32_t get_raw16() {
    uint32_t v = peek();
    advance(v, 1);
    return v;
  }

  // A complete, uncorrupted decode is the exact inverse of the encode: the
  // state walks back to the encoder's initial kRansL and every renorm byte
  // is consumed. Anything else means a truncated/corrupt stream.
  inline bool ok() const { return x == kRansL && pos == len; }
};

// --- Shared escape layout ----------------------------------------------
// Out-of-alphabet symbols are coded as ESC (the model's last index) followed
// by the raw 32-bit value in two 16-bit halves: the LOW half is pushed first
// (decoded LAST), the HIGH half second. ONE definition for every coder in
// rans.cc / ar_wavefront.cc / ar_portable.cc — the encode and decode sides
// must never be edited independently (repo determinism contract).

inline void put_escape_value(Encoder& enc, int32_t v) {
  const uint32_t u = static_cast<uint32_t>(v) + 0x80000000u;
  enc.put_raw16(u & 0xffffu);          // decoded last
  enc.put_raw16((u >> 16) & 0xffffu);  // decoded second
}

inline int32_t get_escape_value(Decoder& dec) {
  const uint32_t hi = dec.get_raw16();
  const uint32_t lo = dec.get_raw16();
  return static_cast<int32_t>(((hi << 16) | lo) - 0x80000000u);
}

// ---------------------------------------------------------------------------
// Deterministic per-symbol CDF construction
// ---------------------------------------------------------------------------

inline double std_normal_cdf(double v) { return 0.5 * std::erfc(-v * M_SQRT1_2); }

// --- Fast float normal CDF (no libm in the hot loop) ------------------------
// e^x for x <= 0 via 2^t split + degree-5 Chebyshev polynomial; ~1.2e-7
// relative error (test-pinned).
// Fully branch-free (the underflow clamp is a max, e^-87 ~ 1.6e-38 ~ 0 for
// CDF purposes) so the per-edge loop in build_gaussian_model vectorizes.
inline float fast_exp(float x) {
  x = x < -87.0f ? -87.0f : x;
  const float t = x * 1.44269504089f;  // x * log2(e)
  const float fi = std::floor(t);
  const float f = t - fi;
  const int i = static_cast<int>(fi);
  // 2^f on [0, 1): degree-5 Chebyshev fit, max rel err 1.2e-7 with f32
  // coefficients (the truncated Taylor series this replaces was ~1.5e-4 at
  // f -> 1; pinned by tests/test_codec.py::test_fast_math_accuracy)
  const float p =
      0.9999998984f +
      f * (0.69315449f +
           f * (0.24014182f +
                f * (0.055860337f +
                     f * (0.0089495904f + f * 0.0018937541f))));
  union {
    uint32_t u;
    float fl;
  } s;
  s.u = static_cast<uint32_t>(i + 127) << 23;
  return p * s.fl;
}

// ln(y) for y > 0 via exponent split + atanh series on the mantissa
// (t = (m-1)/(m+1), |t| <= 0.172 -> series error ~1e-8). Branch-light,
// deterministic, vectorizable.
inline float fast_log(float y) {
  union {
    float f;
    uint32_t u;
  } v;
  v.f = y;
  int e = static_cast<int>((v.u >> 23) & 0xffu) - 127;
  v.u = (v.u & 0x007fffffu) | 0x3f800000u;  // mantissa in [1, 2)
  float m = v.f;
  const bool hi = m > 1.41421356f;
  m = hi ? 0.5f * m : m;  // [0.707, 1.414)
  e += hi ? 1 : 0;
  const float t = (m - 1.0f) / (m + 1.0f);
  const float t2 = t * t;
  const float p =
      2.0f * t *
      (1.0f + t2 * (0.33333334f +
                    t2 * (0.2f + t2 * (0.14285715f + t2 * 0.11111111f))));
  return p + static_cast<float>(e) * 0.69314718f;
}

// softplus(x) = log(1 + e^x) = max(x, 0) + log1p(e^-|x|), all-fast-path.
// ~1e-7 absolute error — invisible to the 16-bit CDF quantizer downstream.
inline float fast_softplus(float x) {
  const float ax = x > 0.0f ? x : -x;
  const float mx = x > 0.0f ? x : 0.0f;
  return mx + fast_log(1.0f + fast_exp(-ax));
}

// Standard normal CDF via Abramowitz–Stegun 7.1.26 erf (max abs err 1.5e-7)
// — plenty for 16-bit fixed-point CDFs. Deterministic: pure float arithmetic,
// identical code at encode and decode.
inline float fast_normal_cdf(float v) {
  const float x = v * 0.70710678118f;  // v / sqrt(2)
  const float ax = x < 0.0f ? -x : x;
  const float t = 1.0f / (1.0f + 0.3275911f * ax);
  const float poly =
      t * (0.254829592f +
           t * (-0.284496736f +
                t * (1.421413741f + t * (-1.453152027f + t * 1.061405429f))));
  const float erf_ax = 1.0f - poly * fast_exp(-ax * ax);
  const float erf_x = x < 0.0f ? -erf_ax : erf_ax;
  return 0.5f * (1.0f + erf_x);
}

// Scratch for one symbol's quantized model. Fixed-size arrays (no heap) so
// the wavefront inner loop does zero allocation; nsym <= 2*254 + 2 = 510.
struct SymbolModel {
  int c;              // alphabet center
  int R;              // span: d in [-R, R]
  int nsym;           // 2R + 2 (incl. escape, last index)
  uint32_t cum[512];  // nsym + 1 entries used; cum[nsym] == kProbScale
};

// Minimum alphabet half-span. The 6*std rule alone makes the window as
// sharp as the model's confidence — and converged models are routinely
// overconfident (tiny sigma, mu off by several integers), which forced
// 32-bit raw escapes on exactly the symbols the model mispredicts. A wide
// floor turns those misses into in-window symbols whose freq>=1 leak
// prices them at <= 16 bits (cheaper than the analytic 1e-9 floor's 29.9):
// measured on the converged hyperprior/checkerboard/joint-AR ladder
// checkpoints this cut y-stream rates 34-45% (tools/diag_rmin_sweep.py).
// Cost for well-calibrated symbols is only the floor mass (~2R/65536 ~
// 0.1% => ~0.0015 bits/sym); build cost stays O(sigma-width) thanks to the
// saturation window below. Spec constant: encode and decode must agree.
constexpr int kRMinWindow = 32;

// Builds the quantized CDF for a (mixture-of-)Gaussian symbol.
// mus/sigmas/ws point to K components (K==1: plain Gaussian, ws ignored).
inline void build_gaussian_model(const float* ws, const float* mus,
                                 const float* sigmas, int K, SymbolModel* m) {
  double mean = 0.0, m2 = 0.0;
  for (int k = 0; k < K; ++k) {
    double w = (K == 1) ? 1.0 : static_cast<double>(ws[k]);
    double mu = mus[k], s = sigmas[k];
    mean += w * mu;
    m2 += w * (s * s + mu * mu);
  }
  double var = m2 - mean * mean;
  double stdd = std::sqrt(var > 1e-12 ? var : 1e-12);
  int c = static_cast<int>(std::lrint(mean));
  int R = static_cast<int>(std::ceil(6.0 * stdd)) + 2;
  if (R < kRMinWindow) R = kRMinWindow;
  if (R > 254) R = 254;
  int nsym = 2 * R + 2;

  // mixture CDF at the 2R+2 bin edges (one CDF eval per edge per component),
  // then difference into the pmf — half the transcendental work of
  // evaluating upper/lower per bin. Float + polynomial CDF: component-outer
  // so mu/sigma are loop constants and the edge loop auto-vectorizes;
  // 1e-7-level CDF error is invisible to a 16-bit fixed-point quantizer.
  float edge[512];
  int n_edges = 2 * R + 2;
  for (int e = 0; e < n_edges; ++e) edge[e] = 0.0f;
  const float base = static_cast<float>(c - R) - 0.5f;
  for (int k = 0; k < K; ++k) {
    const float w = (K == 1) ? 1.0f : ws[k];
    const float mu = mus[k];
    const float inv = 1.0f / sigmas[k];
    // fast_normal_cdf saturates to exactly 0.0f / 1.0f past ~5.5 sigma in
    // f32 (poly * e^{-x^2} drops under 2^-25), so only edges within an
    // 8-sigma window of mu need evaluating — the rest contribute exactly
    // 0 or w. Keeps build cost O(sigma-width) instead of O(R), which is
    // what makes the wide kRMinWindow affordable in the wavefront loop.
    // Bit-identical to evaluating every edge (encode == decode).
    // clamp in float space BEFORE the int cast (float->int overflow is UB;
    // sigma can be huge or non-finite on a garbage model)
    float lo_f = (mu - 8.0f * sigmas[k]) - base;
    float hi_f = (mu + 8.0f * sigmas[k]) - base;
    const float ne = static_cast<float>(n_edges);
    lo_f = (lo_f > 0.0f) ? (lo_f < ne ? lo_f : ne) : 0.0f;    // NaN -> 0
    hi_f = (hi_f > lo_f) ? (hi_f < ne ? hi_f : ne) : lo_f;
    int lo = static_cast<int>(lo_f);
    int hi = static_cast<int>(hi_f) + 1;
    if (hi > n_edges) hi = n_edges;
    for (int e = hi; e < n_edges; ++e) edge[e] += w;
    for (int e = lo; e < hi; ++e)
      edge[e] += w * fast_normal_cdf((base + e - mu) * inv);
  }
  float pmf[512];
  float total = 0.0f;
  for (int d = -R; d <= R; ++d) {
    float p = edge[d + R + 1] - edge[d + R];
    if (p < 0.0f) p = 0.0f;
    pmf[d + R] = p;
    total += p;
  }
  float esc = 1.0f - total;
  if (esc < 0.0f) esc = 0.0f;
  pmf[nsym - 1] = esc;
  total += esc;
  if (total <= 0.0f) total = 1.0f;

  // Quantize: every symbol gets freq >= 1; remainder to the most likely one.
  m->c = c;
  m->R = R;
  m->nsym = nsym;
  uint32_t budget = kProbScale - static_cast<uint32_t>(nsym);
  uint32_t acc = 0;
  int argmax = 0;
  double pmax = -1.0;
  uint32_t freq[512];
  const float scale = static_cast<float>(budget) / total;
  for (int j = 0; j < nsym; ++j) {
    uint32_t f = 1 + static_cast<uint32_t>(pmf[j] * scale);
    freq[j] = f;
    acc += f;
    if (pmf[j] > pmax) {
      pmax = pmf[j];
      argmax = j;
    }
  }
  // Signed remainder: float truncation error can push acc a few counts past
  // the budget; argmax's freq is the largest so it absorbs either sign.
  freq[argmax] = static_cast<uint32_t>(
      static_cast<int64_t>(freq[argmax]) +
      (static_cast<int64_t>(kProbScale) - static_cast<int64_t>(acc)));
  m->cum[0] = 0;
  for (int j = 0; j < nsym; ++j) m->cum[j + 1] = m->cum[j] + freq[j];
}

// Binary search: find j with cum[j] <= cf < cum[j+1].
inline int cdf_find(const uint32_t* cum, int nsym, uint32_t cf) {
  int lo = 0, hi = nsym;
  while (hi - lo > 1) {
    int mid = (lo + hi) >> 1;
    if (cum[mid] <= cf) lo = mid;
    else hi = mid;
  }
  return lo;
}

}  // namespace nic

#endif  // NIC_RANS_CORE_H_
