// Native autoregressive wavefront codec for the masked-conv context model.
//
// The reference never decodes from a bitstream — its "decode" is the parallel
// eval forward (Models.py:63-90). Real AR decoding must recompute each
// pixel's entropy parameters from already-decoded neighbors. The Python/numpy
// wavefront path (coding/codec.py) is correctness-first but pays ~8 numpy +
// ctypes crossings per wave (141 waves for a Kodak-sized latent grid). This
// file runs the ENTIRE wavefront loop in one native call:
//
//   per wave t = 3*i + j (dependency-safe for the 5x5 mask-A context):
//     gather the 12 causal neighbor positions  -> A   (n, 12*M)
//     phi = A @ ctx_w + ctx_b                  -> (n, 2*M)    [masked conv]
//     h1  = phi @ W1_phi + P[pixels]           -> (n, hidden) [EP layer 1]
//     h2  = lrelu(h1) @ W2 + b2, lrelu         -> (n, hidden)
//     h3  = h2 @ W3 + b3                       -> (n, out)
//     per pixel/channel: softmax/softplus -> Gaussian/GMM model -> rANS
//
// P = psi @ W1_psi + b1 is precomputed once per image (the psi half of EP
// layer 1 does not depend on decoded context), saving ~30% of the per-wave
// GEMM work and one concat.
//
// Determinism contract: encode and decode call the SAME noinline GEMM and
// activation routines with IDENTICAL shapes and inputs (causality guarantees
// the gathered context matches), so every float — and hence every quantized
// CDF — is bit-identical on both sides. All GEMMs use a fixed k-outer loop
// order; no threading, no reassociation beyond what the (shared) machine
// code does. Streams are self-consistent per build: encode and decode must
// run the same shared object (cross-machine bit-exactness would additionally
// require a fixed-point parameter path; the reference has no codec at all).

#include <cstdlib>

#if defined(__AVX512F__)
#include <immintrin.h>
#endif

#include "rans_core.h"

using nic::Decoder;
using nic::Encoder;
using nic::SymbolModel;
using nic::build_gaussian_model;
using nic::cdf_find;
using nic::fast_exp;

namespace {

// out (n, md) += A (n, kd) @ W (kd, md).
//
// Two kernels, dispatched ONLY on n (identical shapes at encode and decode,
// so the dispatch — and hence every accumulation order — matches on both
// sides; streams stay self-consistent per build as documented at the top):
//
//  * n >= 32 (the whole-image psi @ W1 precompute, and waves of large
//    images): AVX-512 register-blocked micro-kernel — up to 4 rows x 64
//    columns of accumulators live in zmm registers across the whole k loop,
//    so each k step amortizes 4 W-vector loads over 16 FMAs. Measured 46
//    GFLOP/s at n=1536 vs 31 for the streaming form (this vCPU sustains
//    ~48 GFLOP/s peak — a single AVX-512 FMA port at reduced clock; both
//    kernels are at machine speed for their regime).
//  * small n (typical wave shapes, n <= 16 at Kodak size): k-outer
//    streaming form — W streams sequentially once per call and the few out
//    rows stay cache-resident (40 GFLOP/s measured; the register kernel
//    loses here because masked W reloads per row-block dominate).
#if defined(__AVX512F__)

// One 4-row x 64-col accumulator tile; cols beyond md are masked out.
template <int RB>
inline void gemm_tile(const float* A, int i0, int kd, const float* W, int md,
                      int j0, float* out) {
  __mmask16 msk[4];
  for (int v = 0; v < 4; ++v) {
    const int rem = md - (j0 + 16 * v);
    msk[v] = rem >= 16 ? 0xffff
                       : (rem <= 0 ? 0 : static_cast<__mmask16>(
                                             (1u << rem) - 1u));
  }
  __m512 acc[RB][4];
  for (int r = 0; r < RB; ++r) {
    const float* orow = out + static_cast<size_t>(i0 + r) * md + j0;
    for (int v = 0; v < 4; ++v)
      acc[r][v] = _mm512_maskz_loadu_ps(msk[v], orow + 16 * v);
  }
  for (int k = 0; k < kd; ++k) {
    const float* wrow = W + static_cast<size_t>(k) * md + j0;
    __m512 wv[4];
    for (int v = 0; v < 4; ++v)
      wv[v] = _mm512_maskz_loadu_ps(msk[v], wrow + 16 * v);
    for (int r = 0; r < RB; ++r) {
      const __m512 a =
          _mm512_set1_ps(A[static_cast<size_t>(i0 + r) * kd + k]);
      for (int v = 0; v < 4; ++v)
        acc[r][v] = _mm512_fmadd_ps(a, wv[v], acc[r][v]);
    }
  }
  for (int r = 0; r < RB; ++r) {
    float* orow = out + static_cast<size_t>(i0 + r) * md + j0;
    for (int v = 0; v < 4; ++v)
      _mm512_mask_storeu_ps(orow + 16 * v, msk[v], acc[r][v]);
  }
}

__attribute__((noinline)) void gemm_acc_blocked(const float* A, int n, int kd,
                                                const float* W, int md,
                                                float* out) {
  for (int j0 = 0; j0 < md; j0 += 64) {
    int i0 = 0;
    for (; i0 + 4 <= n; i0 += 4) gemm_tile<4>(A, i0, kd, W, md, j0, out);
    switch (n - i0) {
      case 3: gemm_tile<3>(A, i0, kd, W, md, j0, out); break;
      case 2: gemm_tile<2>(A, i0, kd, W, md, j0, out); break;
      case 1: gemm_tile<1>(A, i0, kd, W, md, j0, out); break;
      default: break;
    }
  }
}
#endif

__attribute__((noinline)) void gemm_acc_stream(const float* A, int n, int kd,
                                               const float* W, int md,
                                               float* out) {
  int k = 0;
  for (; k + 4 <= kd; k += 4) {
    const float* w0 = W + static_cast<size_t>(k) * md;
    const float* w1 = w0 + md;
    const float* w2 = w1 + md;
    const float* w3 = w2 + md;
    for (int i = 0; i < n; ++i) {
      const float* arow = A + static_cast<size_t>(i) * kd + k;
      const float a0 = arow[0], a1 = arow[1], a2 = arow[2], a3 = arow[3];
      float* orow = out + static_cast<size_t>(i) * md;
      for (int j = 0; j < md; ++j)
        orow[j] += a0 * w0[j] + a1 * w1[j] + a2 * w2[j] + a3 * w3[j];
    }
  }
  for (; k < kd; ++k) {
    const float* wrow = W + static_cast<size_t>(k) * md;
    for (int i = 0; i < n; ++i) {
      const float a = A[static_cast<size_t>(i) * kd + k];
      float* orow = out + static_cast<size_t>(i) * md;
      for (int j = 0; j < md; ++j) orow[j] += a * wrow[j];
    }
  }
}

inline void gemm_acc(const float* A, int n, int kd, const float* W, int md,
                     float* out) {
#if defined(__AVX512F__)
  if (n >= 32) {
    gemm_acc_blocked(A, n, kd, W, md, out);
    return;
  }
#endif
  gemm_acc_stream(A, n, kd, W, md, out);
}

__attribute__((noinline)) void leaky_relu(float* x, size_t n) {
  for (size_t i = 0; i < n; ++i) x[i] = x[i] >= 0.0f ? x[i] : 0.01f * x[i];
}

// sigma/weight post-processing runs ~1.2M transcendentals per Kodak image;
// the fast-path exp/log (rans_core.h) keep libm out and let the loops
// vectorize. Same code at encode and decode — bit-identical params.
inline float softplus(float x) { return nic::fast_softplus(x); }

// Weights only — const after create, so one handle is safely shared by
// concurrent encode/decode calls (independent tile streams decode in
// parallel from Python threads; ctypes releases the GIL).
struct ArNets {
  int M, K, phi_dim, psi_dim, hidden, out_dim;
  std::vector<float> ctx_w, ctx_b;    // (12M, phi_dim), (phi_dim,)
  std::vector<float> w1_phi, w1_psi;  // (phi_dim, hidden), (psi_dim, hidden)
  std::vector<float> b1, w2, b2, w3, b3;
};

// Per-call state: one per encode/decode invocation (stack-owned).
struct Scratch {
  const ArNets& net;
  int H, W, nmax;
  std::vector<float> P;      // (H*W, hidden): psi @ w1_psi + b1
  std::vector<float> y_pad;  // (H+4, W+4, M), zero border
  std::vector<float> A, phi, h1, h2, h3;  // wave scratch
  std::vector<int> wave_i, wave_j;        // current wave's pixel coords

  Scratch(const ArNets& n, const float* psi, int h, int w)
      : net(n), H(h), W(w) {
    nmax = (W + 2) / 3 < H ? (W + 2) / 3 : H;
    const size_t hw = static_cast<size_t>(H) * W;
    P.assign(hw * net.hidden, 0.0f);
    for (size_t p = 0; p < hw; ++p)
      std::memcpy(&P[p * net.hidden], net.b1.data(),
                  net.hidden * sizeof(float));
    gemm_acc(psi, static_cast<int>(hw), net.psi_dim, net.w1_psi.data(),
             net.hidden, P.data());
    y_pad.assign(static_cast<size_t>(H + 4) * (W + 4) * net.M, 0.0f);
    A.resize(static_cast<size_t>(nmax) * 12 * net.M);
    phi.resize(static_cast<size_t>(nmax) * net.phi_dim);
    h1.resize(static_cast<size_t>(nmax) * net.hidden);
    h2.resize(static_cast<size_t>(nmax) * net.hidden);
    h3.resize(static_cast<size_t>(nmax) * net.out_dim);
    wave_i.resize(nmax);
    wave_j.resize(nmax);
  }

  inline const float* pad_at(int i, int j) const {  // un-offset coords
    return &y_pad[(static_cast<size_t>(i) * (W + 4) + j) * net.M];
  }
  inline float* pad_at(int i, int j) {
    return &y_pad[(static_cast<size_t>(i) * (W + 4) + j) * net.M];
  }

  // Collect wave t's pixels (ascending i, matching the Python order).
  int collect_wave(int t) {
    int n = 0;
    int i_lo = (t - W + 1 + 2) / 3;  // ceil((t - W + 1) / 3)
    if (i_lo < 0) i_lo = 0;
    int i_hi = t / 3 < H - 1 ? t / 3 : H - 1;
    for (int i = i_lo; i <= i_hi; ++i) {
      int j = t - 3 * i;
      if (j < 0 || j >= W) continue;
      wave_i[n] = i;
      wave_j[n] = j;
      ++n;
    }
    return n;
  }

  // Gather causal context and run the shared per-wave GEMM stack; h3 holds
  // the raw entropy-parameter outputs for the wave's n pixels afterwards.
  void wave_params(int n) {
    const int M = net.M;
    // mask-A positions: rows 0-1 all 5 cols, row 2 cols 0-1 — the order the
    // ctx_w rows were concatenated in (codec.py _HostParamNets).
    for (int p = 0; p < n; ++p) {
      float* dst = &A[static_cast<size_t>(p) * 12 * M];
      const int i = wave_i[p], j = wave_j[p];
      for (int r = 0; r < 2; ++r)
        std::memcpy(dst + r * 5 * M, pad_at(i + r, j), 5 * M * sizeof(float));
      std::memcpy(dst + 10 * M, pad_at(i + 2, j), 2 * M * sizeof(float));
    }
    for (int p = 0; p < n; ++p)
      std::memcpy(&phi[static_cast<size_t>(p) * net.phi_dim],
                  net.ctx_b.data(), net.phi_dim * sizeof(float));
    gemm_acc(A.data(), n, 12 * M, net.ctx_w.data(), net.phi_dim, phi.data());
    for (int p = 0; p < n; ++p)
      std::memcpy(
          &h1[static_cast<size_t>(p) * net.hidden],
          &P[(static_cast<size_t>(wave_i[p]) * W + wave_j[p]) * net.hidden],
          net.hidden * sizeof(float));
    gemm_acc(phi.data(), n, net.phi_dim, net.w1_phi.data(), net.hidden,
             h1.data());
    leaky_relu(h1.data(), static_cast<size_t>(n) * net.hidden);
    for (int p = 0; p < n; ++p)
      std::memcpy(&h2[static_cast<size_t>(p) * net.hidden], net.b2.data(),
                  net.hidden * sizeof(float));
    gemm_acc(h1.data(), n, net.hidden, net.w2.data(), net.hidden, h2.data());
    leaky_relu(h2.data(), static_cast<size_t>(n) * net.hidden);
    for (int p = 0; p < n; ++p)
      std::memcpy(&h3[static_cast<size_t>(p) * net.out_dim], net.b3.data(),
                  net.out_dim * sizeof(float));
    gemm_acc(h2.data(), n, net.hidden, net.w3.data(), net.out_dim, h3.data());
  }

  // Post-process pixel p's h3 row into per-channel coder params.
  // K==1: mu/sigma (M,) each, ws unused. K>1: (M, K) rows in coder layout
  // (the W3 columns were permuted to (kind, m, k) at create time).
  __attribute__((noinline)) void pixel_params(int p, float* ws, float* mu,
                                              float* sigma) const {
    const int M = net.M, K = net.K;
    const float* row = &h3[static_cast<size_t>(p) * net.out_dim];
    if (K == 1) {
      for (int m = 0; m < M; ++m) {
        mu[m] = row[m];
        sigma[m] = softplus(row[M + m]) + 1e-6f;
      }
      return;
    }
    const int MK = M * K;
    for (int m = 0; m < M; ++m) {
      const float* wr = row + m * K;
      float mx = wr[0];
      for (int k = 1; k < K; ++k) mx = wr[k] > mx ? wr[k] : mx;
      float sum = 0.0f;
      for (int k = 0; k < K; ++k) {
        const float e = fast_exp(wr[k] - mx);
        ws[m * K + k] = e;
        sum += e;
      }
      for (int k = 0; k < K; ++k) ws[m * K + k] /= sum;
      for (int k = 0; k < K; ++k) {
        mu[m * K + k] = row[MK + m * K + k];
        sigma[m * K + k] = softplus(row[2 * MK + m * K + k]) + 1e-6f;
      }
    }
  }
};

// Forward parameter sweep shared by the single-stream and N-stream encoders:
// walks the wavefront exactly like decode does (same Scratch calls, same GEMM
// shapes) and materializes every symbol + its entropy params in coding order.
void collect_all_params(const ArNets& net, Scratch& sc, const float* y_q,
                        int H, int W, int32_t* sym, float* mus, float* sigmas,
                        float* wsv) {
  const int M = net.M, K = net.K;
  const int t_max = 3 * (H - 1) + W;
  size_t s = 0;
  for (int t = 0; t < t_max; ++t) {
    const int n = sc.collect_wave(t);
    if (n == 0) continue;
    sc.wave_params(n);
    for (int p = 0; p < n; ++p) {
      sc.pixel_params(p, wsv ? &wsv[s * K] : nullptr, &mus[s * K],
                      &sigmas[s * K]);
      const float* yrow =
          y_q + (static_cast<size_t>(sc.wave_i[p]) * W + sc.wave_j[p]) * M;
      for (int m = 0; m < M; ++m)
        sym[s + m] = static_cast<int32_t>(std::lrintf(yrow[m]));
      s += M;
    }
  }
}

// Encode symbols [of one residue class] backwards into enc. Identical
// model construction to the decoder (shared build_gaussian_model).
void encode_class(const int32_t* sym, const float* mus, const float* sigmas,
                  const float* wsv, int K, int64_t n_sym, int64_t k,
                  int64_t step, Encoder& enc) {
  SymbolModel sm;
  if (n_sym - 1 < k) return;
  const int64_t hi = ((n_sym - 1 - k) / step) * step + k;
  for (int64_t i = hi; i >= 0; i -= step) {
    const float* w = wsv ? &wsv[i * K] : nullptr;
    build_gaussian_model(w, &mus[i * K], &sigmas[i * K], K, &sm);
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
}

}  // namespace

extern "C" {

// ctx_w: (12*M, phi_dim); w1: (phi_dim + psi_dim, hidden) — split here;
// w3: (hidden, out_dim), ALREADY column-permuted to coder layout for K > 1.
void* arwave_create(int M, int K, int phi_dim, int psi_dim, int hidden,
                    int out_dim, const float* ctx_w, const float* ctx_b,
                    const float* w1, const float* b1, const float* w2,
                    const float* b2, const float* w3, const float* b3) {
  ArNets* n = new ArNets();
  n->M = M;
  n->K = K;
  n->phi_dim = phi_dim;
  n->psi_dim = psi_dim;
  n->hidden = hidden;
  n->out_dim = out_dim;
  n->ctx_w.assign(ctx_w, ctx_w + static_cast<size_t>(12) * M * phi_dim);
  n->ctx_b.assign(ctx_b, ctx_b + phi_dim);
  n->w1_phi.assign(w1, w1 + static_cast<size_t>(phi_dim) * hidden);
  n->w1_psi.assign(w1 + static_cast<size_t>(phi_dim) * hidden,
                   w1 + static_cast<size_t>(phi_dim + psi_dim) * hidden);
  n->b1.assign(b1, b1 + hidden);
  n->w2.assign(w2, w2 + static_cast<size_t>(hidden) * hidden);
  n->b2.assign(b2, b2 + hidden);
  n->w3.assign(w3, w3 + static_cast<size_t>(hidden) * out_dim);
  n->b3.assign(b3, b3 + out_dim);
  return n;
}

void arwave_destroy(void* h) { delete static_cast<ArNets*>(h); }

// Profiling hook: runs ONLY the forward parameter sweep (context gathers,
// GEMM stack, softmax/softplus post-processing) with no CDF build and no
// rANS — so (encode time - sweep time) isolates the model-build + coder
// cost. Returns a checksum so the work can't be optimized away.
float arwave_param_sweep(void* handle, const float* y_q, const float* psi,
                         int H, int W) {
  const ArNets& net = *static_cast<ArNets*>(handle);
  const int M = net.M, K = net.K;
  Scratch sc(net, psi, H, W);
  for (int i = 0; i < H; ++i)
    std::memcpy(sc.pad_at(i + 2, 2), y_q + static_cast<size_t>(i) * W * M,
                static_cast<size_t>(W) * M * sizeof(float));
  std::vector<float> ws(K > 1 ? static_cast<size_t>(M) * K : 0);
  std::vector<float> mu(static_cast<size_t>(M) * K),
      sigma(static_cast<size_t>(M) * K);
  float acc = 0.0f;
  const int t_max = 3 * (H - 1) + W;
  for (int t = 0; t < t_max; ++t) {
    const int n = sc.collect_wave(t);
    if (n == 0) continue;
    sc.wave_params(n);
    for (int p = 0; p < n; ++p) {
      sc.pixel_params(p, K > 1 ? ws.data() : nullptr, mu.data(),
                      sigma.data());
      acc += mu[0] + sigma[0];
    }
  }
  return acc;
}

// y_q: (H, W, M) float32 holding integers; psi: (H, W, psi_dim) float32.
// Returns stream length, or -1 on overflow.
int arwave_encode(void* handle, const float* y_q, const float* psi, int H,
                  int W, uint8_t* out, int cap) {
  const ArNets& net = *static_cast<ArNets*>(handle);
  const int M = net.M, K = net.K;
  Scratch sc(net, psi, H, W);
  // The full y_q is a valid context at every wave (the mask only reads
  // already-coded positions), so fill the padded buffer up front.
  for (int i = 0; i < H; ++i)
    std::memcpy(sc.pad_at(i + 2, 2), y_q + static_cast<size_t>(i) * W * M,
                static_cast<size_t>(W) * M * sizeof(float));

  const size_t n_sym = static_cast<size_t>(H) * W * M;
  std::vector<int32_t> sym(n_sym);
  std::vector<float> mus(n_sym * K), sigmas(n_sym * K);
  std::vector<float> wsv(K > 1 ? n_sym * K : 0);
  collect_all_params(net, sc, y_q, H, W, sym.data(), mus.data(),
                     sigmas.data(), K > 1 ? wsv.data() : nullptr);

  Encoder enc;
  enc.bytes.reserve(n_sym * 2 + 16);
  encode_class(sym.data(), mus.data(), sigmas.data(),
               K > 1 ? wsv.data() : nullptr, K,
               static_cast<int64_t>(n_sym), 0, 1, enc);
  return enc.flush(out, cap);
}

// N-way interleaved variant: symbol s goes to stream s % nstreams. Entropy
// params and per-symbol CDFs are IDENTICAL to the single-stream coder (same
// forward sweep, same model code), so the rate cost is nstreams-1 extra
// rANS flush constants (~4 bytes each) — there is NO context reset and NO
// rate penalty, unlike independent tiles. A multicore decoder pulls the
// streams concurrently (one thread per stream) inside each wavefront while
// context stays exact. Payload: u32 lens[nstreams] | stream 0 | ... | N-1.
int arwave_encode_n(void* handle, const float* y_q, const float* psi, int H,
                    int W, int nstreams, uint8_t* out, int cap) {
  const ArNets& net = *static_cast<ArNets*>(handle);
  const int M = net.M, K = net.K;
  if (nstreams < 1 || nstreams > 255) return -1;  // mirror of decode_n
  Scratch sc(net, psi, H, W);
  for (int i = 0; i < H; ++i)
    std::memcpy(sc.pad_at(i + 2, 2), y_q + static_cast<size_t>(i) * W * M,
                static_cast<size_t>(W) * M * sizeof(float));

  const int64_t n_sym = static_cast<int64_t>(H) * W * M;
  std::vector<int32_t> sym(n_sym);
  std::vector<float> mus(n_sym * K), sigmas(n_sym * K);
  std::vector<float> wsv(K > 1 ? n_sym * K : 0);
  collect_all_params(net, sc, y_q, H, W, sym.data(), mus.data(),
                     sigmas.data(), K > 1 ? wsv.data() : nullptr);

  std::vector<std::vector<uint8_t>> parts(nstreams);
#pragma omp parallel for schedule(static, 1)
  for (int k = 0; k < nstreams; ++k) {
    Encoder enc;
    enc.bytes.reserve(n_sym * 2 / nstreams + 16);
    encode_class(sym.data(), mus.data(), sigmas.data(),
                 K > 1 ? wsv.data() : nullptr, K, n_sym, k, nstreams, enc);
    parts[k].resize(enc.bytes.size() + 8);
    const int ln = enc.flush(parts[k].data(),
                             static_cast<int>(parts[k].size()));
    parts[k].resize(ln);
  }

  int64_t total = 4 * static_cast<int64_t>(nstreams);
  for (int k = 0; k < nstreams; ++k) total += parts[k].size();
  if (total > cap) return -1;
  uint8_t* p = out;
  for (int k = 0; k < nstreams; ++k) {
    const uint32_t ln = static_cast<uint32_t>(parts[k].size());
    std::memcpy(p, &ln, 4);
    p += 4;
  }
  for (int k = 0; k < nstreams; ++k) {
    std::memcpy(p, parts[k].data(), parts[k].size());
    p += parts[k].size();
  }
  return static_cast<int>(total);
}

// Decodes (H, W, M) float32 latents into y_out. Returns 0, or -1 if the
// stream is truncated/corrupt (final rANS state check fails).
int arwave_decode(void* handle, const uint8_t* buf, int len, const float* psi,
                  int H, int W, float* y_out) {
  const ArNets& net = *static_cast<ArNets*>(handle);
  const int M = net.M, K = net.K;
  Scratch sc(net, psi, H, W);
  Decoder dec;
  dec.init(buf, len);

  std::vector<float> ws(K > 1 ? static_cast<size_t>(M) * K : 0);
  std::vector<float> mu(static_cast<size_t>(M) * K),
      sigma(static_cast<size_t>(M) * K);
  SymbolModel sm;

  const int t_max = 3 * (H - 1) + W;
  for (int t = 0; t < t_max; ++t) {
    const int n = sc.collect_wave(t);
    if (n == 0) continue;
    sc.wave_params(n);
    for (int p = 0; p < n; ++p) {
      sc.pixel_params(p, K > 1 ? ws.data() : nullptr, mu.data(),
                      sigma.data());
      const int i = sc.wave_i[p], j = sc.wave_j[p];
      float* dst = y_out + (static_cast<size_t>(i) * W + j) * M;
      for (int m = 0; m < M; ++m) {
        build_gaussian_model(K > 1 ? &ws[m * K] : nullptr, &mu[m * K],
                             &sigma[m * K], K, &sm);
        const uint32_t cf = dec.peek();
        const int jj = cdf_find(sm.cum, sm.nsym, cf);
        dec.advance(sm.cum[jj], sm.cum[jj + 1] - sm.cum[jj]);
        const int32_t v = (jj == sm.nsym - 1)
            ? nic::get_escape_value(dec) : sm.c + (jj - sm.R);
        dst[m] = static_cast<float>(v);
      }
      std::memcpy(sc.pad_at(i + 2, j + 2), dst, M * sizeof(float));
    }
  }
  return dec.ok() ? 0 : -1;
}

// Decode an N-way interleaved stream (see arwave_encode_n). Per wave: the
// shared GEMM stack computes every pixel's entropy params, then the
// nstreams rANS streams are pulled independently (parallel when OpenMP
// threads are available — each stream's symbols form a residue class, and
// within a wave all models are already known, so streams never interact).
int arwave_decode_n(void* handle, const uint8_t* buf, int len,
                    const float* psi, int H, int W, int nstreams,
                    float* y_out) {
  const ArNets& net = *static_cast<ArNets*>(handle);
  const int M = net.M, K = net.K;
  if (nstreams < 1 || len < 4 * nstreams) return -1;
  std::vector<Decoder> decs(nstreams);
  {
    int64_t off = 4 * static_cast<int64_t>(nstreams);
    for (int k = 0; k < nstreams; ++k) {
      uint32_t ln;
      std::memcpy(&ln, buf + 4 * k, 4);
      if (off + ln > len) return -1;
      decs[k].init(buf + off, static_cast<int>(ln));
      off += ln;
    }
    if (off != len) return -1;  // trailing bytes outside every slice
  }
  Scratch sc(net, psi, H, W);

  // Per-wave parameter staging: (p, m, k) layout matching pixel_params.
  const size_t wave_cap = static_cast<size_t>(sc.nmax) * M * K;
  std::vector<float> wmu(wave_cap), wsig(wave_cap),
      wws(K > 1 ? wave_cap : 0);
  std::vector<float> val(static_cast<size_t>(sc.nmax) * M);

  const int t_max = 3 * (H - 1) + W;
  int64_t s_base = 0;
  for (int t = 0; t < t_max; ++t) {
    const int n = sc.collect_wave(t);
    if (n == 0) continue;
    sc.wave_params(n);
    for (int p = 0; p < n; ++p)
      sc.pixel_params(p, K > 1 ? &wws[static_cast<size_t>(p) * M * K] : nullptr,
                      &wmu[static_cast<size_t>(p) * M * K],
                      &wsig[static_cast<size_t>(p) * M * K]);

    const int64_t n_wave = static_cast<int64_t>(n) * M;
#pragma omp parallel for schedule(static, 1)
    for (int k = 0; k < nstreams; ++k) {
      SymbolModel sm;
      Decoder& dec = decs[k];
      // first rel >= 0 with (s_base + rel) % nstreams == k
      int64_t rel = (k - (s_base % nstreams) + nstreams) % nstreams;
      for (; rel < n_wave; rel += nstreams) {
        const size_t idx = static_cast<size_t>(rel);
        build_gaussian_model(K > 1 ? &wws[idx * K] : nullptr, &wmu[idx * K],
                             &wsig[idx * K], K, &sm);
        const uint32_t cf = dec.peek();
        const int jj = cdf_find(sm.cum, sm.nsym, cf);
        dec.advance(sm.cum[jj], sm.cum[jj + 1] - sm.cum[jj]);
        const int32_t v = (jj == sm.nsym - 1)
            ? nic::get_escape_value(dec) : sm.c + (jj - sm.R);
        val[idx] = static_cast<float>(v);
      }
    }

    for (int p = 0; p < n; ++p) {
      const int i = sc.wave_i[p], j = sc.wave_j[p];
      float* dst = y_out + (static_cast<size_t>(i) * W + j) * M;
      std::memcpy(dst, &val[static_cast<size_t>(p) * M], M * sizeof(float));
      std::memcpy(sc.pad_at(i + 2, j + 2), dst, M * sizeof(float));
    }
    s_base += n_wave;
  }
  for (int k = 0; k < nstreams; ++k)
    if (!decs[k].ok()) return -1;
  return 0;
}

}  // extern "C"

extern "C" {

// Test shim: evaluate the deterministic fast-math primitives over an array
// so accuracy is pinned by unit tests (tests/test_codec.py). log_out is
// computed for x > 0 inputs only (callers restrict the domain).
void nic_fastmath_eval(const float* x, int n, float* exp_out, float* log_out,
                       float* softplus_out, float* cdf_out) {
  for (int i = 0; i < n; ++i) {
    exp_out[i] = nic::fast_exp(x[i] > 0.0f ? -x[i] : x[i]);  // domain <= 0
    log_out[i] = x[i] > 0.0f ? nic::fast_log(x[i]) : 0.0f;
    softplus_out[i] = nic::fast_softplus(x[i]);
    cdf_out[i] = nic::fast_normal_cdf(x[i]);
  }
}

}  // extern "C"
