// Host-side rANS entropy coder for TPU-computed distributions.
//
// The reference codebase has NO bitstream coder at all — its rate is analytic
// (-sum log p, RateDistortionLoss.py:13-17) and its per-channel CDF hooks
// (EntropyModels.py:153-184) are only used for plotting. This file provides
// the real codec: a byte-wise 32-bit rANS with 16-bit fixed-point CDFs.
//
// Split of labor (TPU-first design):
//   * TPU computes the heavy NN-side quantities: per-symbol Gaussian /
//     mixture parameters (mu, sigma, weights) and per-channel factorized CDF
//     grids.
//   * This coder derives deterministic fixed-point CDFs from those parameters
//     (identically at encode and decode time — both sides run the same code
//     on the same floats) and does the serial entropy coding the TPU cannot.
//
// Streams are LIFO: symbols are encoded in REVERSE order so they decode in
// forward (raster) order — required for the autoregressive wavefront decoder,
// which learns each pixel's parameters only after decoding its causal context.
//
// Symbol model for Gaussian/GMM paths: alphabet centered at the (mixture)
// mean c = lrint(E[y]), span d in [-R, R] with
// R = clamp(ceil(6*std)+2, kRMinWindow=32, 254) (wide floor: see rans_core.h),
// plus an ESC symbol carrying outliers as two raw 16-bit halves.
//
// Core primitives live in rans_core.h (shared with ar_wavefront.cc, the
// native autoregressive wavefront codec).

#include "rans_core.h"

using nic::Decoder;
using nic::Encoder;
using nic::SymbolModel;
using nic::build_gaussian_model;
using nic::cdf_find;

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------

extern "C" {

// --- Gaussian / GMM stream --------------------------------------------------
// Layout of params: mus/sigmas/ws are (n, K) row-major; K==1 ws may be null.

int rans_encode_gaussian(const int32_t* sym, const float* ws, const float* mus,
                         const float* sigmas, int K, int n, uint8_t* out,
                         int cap) {
  Encoder enc;
  enc.bytes.reserve(n * 2 + 16);
  SymbolModel m;
  for (int i = n - 1; i >= 0; --i) {
    const float* w = ws ? ws + static_cast<size_t>(i) * K : nullptr;
    build_gaussian_model(w, mus + static_cast<size_t>(i) * K,
                         sigmas + static_cast<size_t>(i) * K, K, &m);
    int d = sym[i] - m.c;
    if (d >= -m.R && d <= m.R) {
      int j = d + m.R;
      enc.put(m.cum[j], m.cum[j + 1] - m.cum[j]);
    } else {
      nic::put_escape_value(enc, sym[i]);
      int j = m.nsym - 1;                  // ESC decoded first
      enc.put(m.cum[j], m.cum[j + 1] - m.cum[j]);
    }
  }
  return enc.flush(out, cap);
}

struct RansDec {
  Decoder d;
};

void* rans_dec_create(const uint8_t* buf, int len) {
  RansDec* r = new RansDec();
  r->d.init(buf, len);
  return r;
}

void rans_dec_destroy(void* p) { delete static_cast<RansDec*>(p); }

// 1 iff every byte was consumed and the state walked back to kRansL — the
// complete-decode invariant (Decoder::ok). Callers that finished decoding a
// stream should check this: a truncated/corrupt stream otherwise yields
// garbage symbols silently.
int rans_dec_ok(void* p) {
  return static_cast<RansDec*>(p)->d.ok() ? 1 : 0;
}

// Decode n symbols with per-symbol (mixture-)Gaussian params.
void rans_dec_gaussian(void* p, const float* ws, const float* mus,
                       const float* sigmas, int K, int n, int32_t* out) {
  Decoder& dec = static_cast<RansDec*>(p)->d;
  SymbolModel m;
  for (int i = 0; i < n; ++i) {
    const float* w = ws ? ws + static_cast<size_t>(i) * K : nullptr;
    build_gaussian_model(w, mus + static_cast<size_t>(i) * K,
                         sigmas + static_cast<size_t>(i) * K, K, &m);
    uint32_t cf = dec.peek();
    int j = cdf_find(m.cum, m.nsym, cf);
    dec.advance(m.cum[j], m.cum[j + 1] - m.cum[j]);
    if (j == m.nsym - 1) {  // escape: two raw halves follow
      out[i] = nic::get_escape_value(dec);
    } else {
      out[i] = m.c + (j - m.R);
    }
  }
}

// --- Indexed-CDF stream (factorized bottleneck, per-channel tables) --------
// cdfs: (n_rows, row_len) row-major cumulative tables; row r describes
// symbols offsets[r] + k for k in [0, sizes[r]-2], with index sizes[r]-1 as
// ESC. cdfs[r][sizes[r]] == 2^16. row_len >= max(sizes)+1.

int rans_encode_indexed(const int32_t* sym, const int32_t* index, int n,
                        const uint32_t* cdfs, int row_len,
                        const int32_t* offsets, const int32_t* sizes,
                        uint8_t* out, int cap) {
  Encoder enc;
  enc.bytes.reserve(n + 16);
  for (int i = n - 1; i >= 0; --i) {
    int r = index[i];
    const uint32_t* cum = cdfs + static_cast<size_t>(r) * row_len;
    int nsym = sizes[r];
    int j = sym[i] - offsets[r];
    if (j >= 0 && j < nsym - 1) {
      enc.put(cum[j], cum[j + 1] - cum[j]);
    } else {
      nic::put_escape_value(enc, sym[i]);
      j = nsym - 1;
      enc.put(cum[j], cum[j + 1] - cum[j]);
    }
  }
  return enc.flush(out, cap);
}

void rans_dec_indexed(void* p, const int32_t* index, int n,
                      const uint32_t* cdfs, int row_len,
                      const int32_t* offsets, const int32_t* sizes,
                      int32_t* out) {
  Decoder& dec = static_cast<RansDec*>(p)->d;
  for (int i = 0; i < n; ++i) {
    int r = index[i];
    const uint32_t* cum = cdfs + static_cast<size_t>(r) * row_len;
    int nsym = sizes[r];
    uint32_t cf = dec.peek();
    int j = cdf_find(cum, nsym, cf);
    dec.advance(cum[j], cum[j + 1] - cum[j]);
    if (j == nsym - 1) {
      out[i] = nic::get_escape_value(dec);
    } else {
      out[i] = offsets[r] + j;
    }
  }
}

}  // extern "C"
