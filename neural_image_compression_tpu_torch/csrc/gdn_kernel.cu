// GDN / IGDN forward for Hopper (sm_90a): a tensor-core kernel.
//
//   out[n, o] = x[n, o] * rsqrt(beta[o] + sum_i x[n, i]^2 * gamma[i, o])   (GDN)
//   out[n, o] = x[n, o] * sqrt (beta[o] + sum_i x[n, i]^2 * gamma[i, o])   (IGDN)
//
// Replaces the Pallas TPU kernel neural_image_compression_tpu/ops/pallas/
// gdn_kernel.py (`_kernel`, launched by `fused_gdn`). gamma is (C_in, C_out)
// and beta is (C,), both float32 and already reparametrized (ops/bound.nonneg)
// by the caller. x and out are (N, C) row-major rows of an NHWC activation,
// float32 or bfloat16 (out in x's type), with C from 1 to 256.
//
// What bounds it: the channel mix is an (N, C) x (C, C) product, 2*N*C^2
// operations against 2*N*C*sizeof(x) bytes of x and out. On the tensor cores
// (495 TFLOP/s TF32) the operations take about a fifth of the time the bytes
// take at 3.35 TB/s, so once the tensor cores carry the product the kernel is
// bound by bytes, in float32 and in bfloat16. Its aim is to read x once and
// write out once, and to keep the tensor cores and the epilogue under the
// shadow of those copies. Split three ways (below), the products take about
// two thirds of the bytes' time at C = 128, and as long as the bytes at
// C = 192 and longer at 256: there they must overlap the copies almost
// completely.
//
// Precision: a single TF32 or bf16 product (11 or 8 significant bits) would
// move the norm by about 1e-3 relative. So each product is split and all
// sums are float32 (the wgmma accumulator):
//   - float32 x: 3xTF32. s = x*x in float32; s_hi = tf32_rna(s),
//     s_lo = tf32_rna(s - s_hi), and gamma likewise; the sum takes
//     s_lo*g_hi + s_hi*g_lo + s_hi*g_hi (s_lo*g_lo, about 2^-22 relative,
//     is dropped). Relative error of the norm about 1e-7.
//   - bfloat16 x: 3xbf16 at twice the TF32 rate. The square of a bf16 value
//     has at most 16 significant bits, so s_hi = bf16(s), s_lo = bf16(s - s_hi)
//     is exact; gamma splits into a bf16 hi and lo. Relative error of the norm
//     below 1e-5, far under half a bf16 step of the output (about 2e-3).
//
// Design, by width (C padded to CP, a multiple of 64, in shared memory only):
//   - CP = 64 and 128: the loop of csrc/gdn_wgmma.cuh (persistent blocks, a
//     TMA ring of 64-row x tiles, gamma^T's hi and lo planes resident as
//     wgmma's B, x squared and split in registers as A). Every output
//     channel's gamma fits in one block beside the ring, so each block
//     reads its tiles once. Two (float32) or three (bfloat16) warpgroups
//     take turns on the tiles; three measured faster for bf16 and slower
//     for float32 (register cap of 168 a thread at 384 threads). Epilogue:
//     + beta, rsqrt/sqrt, times x read from the same shared tile, written
//     back in place in x's type, then one TMA store per column block (TMA
//     clips the ragged last tile, so the wrapper pads no rows).
//   - CP = 192 and 256: the loop of csrc/gdn_wide.cuh. gamma's planes do
//     not fit in one block there, so a thread-block cluster holds them in
//     slices, each x box comes from L2 once per cluster (TMA multicast), a
//     producer thread keeps a ring of boxes in flight that the consumers
//     release once the products that read them are issued, and the
//     epilogue writes out from registers. That file says why.
// A row stride that is not a multiple of 16 bytes cannot be described to
// TMA: the wrapper pads such x (test widths only) before the launch.
// The kernels' names keep `gdn_rows_kernel`: tools/profile_torch_serve.py
// finds them by that name.

#include "gdn_wide.cuh"

namespace {

// out = x * rsqrt(norm) (or sqrt), for two neighbouring channels, in place.
// (norm >= beta > 0; both approximations are within 2^-22 relative)
template <bool INVERSE>
__device__ __forceinline__ float scale(float norm) {
  float r;
  if (INVERSE) {
    asm("sqrt.approx.f32 %0, %1;\n" : "=f"(r) : "f"(norm));
  } else {
    r = rsqrtf(norm);
  }
  return r;
}
template <bool INVERSE>
__device__ __forceinline__ void epilogue_pair(float, uint8_t* p, float n0, float n1) {
  float2 v = *reinterpret_cast<float2*>(p);
  v.x *= scale<INVERSE>(n0);
  v.y *= scale<INVERSE>(n1);
  *reinterpret_cast<float2*>(p) = v;
}
template <bool INVERSE>
__device__ __forceinline__ void epilogue_pair(__nv_bfloat16, uint8_t* p, float n0, float n1) {
  const uint32_t w = *reinterpret_cast<uint32_t*>(p);
  const float x0 = __uint_as_float(w << 16), x1 = __uint_as_float(w & 0xffff0000u);
  *reinterpret_cast<__nv_bfloat162*>(p) =
      __floats2bfloat162_rn(x0 * scale<INVERSE>(n0), x1 * scale<INVERSE>(n1));
}

// --- the kernel -----------------------------------------------------------------

template <typename T, int CP, bool INVERSE>
struct ForwardEpilogue {
  __device__ __forceinline__ void operator()(uint8_t* tile, const float* acc,
                                             const float* beta_s, int, int ra,
                                             int t4) const {
    using K = Cfg<T, CP>;
#pragma unroll
    for (int j = 0; j < K::NB / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = 8 * j + 2 * t4;
        uint8_t* p = tile + (col / K::COLS) * BOX_TILE_BYTES +
                     swz(ra + 8 * h, (col % K::COLS) * K::ESZ);
        epilogue_pair<INVERSE>(T(), p, acc[4 * j + 2 * h] + beta_s[col],
                               acc[4 * j + 2 * h + 1] + beta_s[col + 1]);
      }
    }
  }
};

template <typename T, int CP, bool INVERSE>
__global__ void __launch_bounds__(Cfg<T, CP>::THREADS, 1)
gdn_rows_kernel(const __grid_constant__ CUtensorMap x_map,
                const __grid_constant__ CUtensorMap out_map,
                const float* __restrict__ gamma, const float* __restrict__ beta,
                int n_rows, int c) {
  mix_rows<T, CP, false, true>(&x_map, &out_map, gamma, beta, n_rows, c,
                               ForwardEpilogue<T, CP, INVERSE>());
}

// --- host side ------------------------------------------------------------------

template <typename T, int CP, bool INVERSE>
cudaError_t launch(const CUtensorMap& x_map, const CUtensorMap& out_map, const float* gamma,
                   const float* beta, int n, int c, cudaStream_t stream) {
  static int sms_of[MAX_DEVICES] = {};
  return launch_persistent<Cfg<T, CP>>(gdn_rows_kernel<T, CP, INVERSE>, sms_of, n, stream,
                                       x_map, out_map, gamma, beta, n, c);
}

template <typename T, int CP>
cudaError_t launch_dir(int inverse, const CUtensorMap& xm, const CUtensorMap& om,
                       const float* g, const float* b, int n, int c, cudaStream_t s) {
  return inverse ? launch<T, CP, true>(xm, om, g, b, n, c, s)
                 : launch<T, CP, false>(xm, om, g, b, n, c, s);
}

template <typename T, int CP, bool INVERSE>
cudaError_t launch_wide(const CUtensorMap& x_map, void* out, const float* gamma,
                        const float* beta, int n, int c, cudaStream_t stream) {
  static int clusters_of[MAX_DEVICES] = {};
  return launch_clusters<Wide<T, CP>>(gdn_rows_kernel_cluster<T, CP, INVERSE>, clusters_of, n,
                                      stream, x_map, static_cast<T*>(out), gamma, beta, n, c);
}

template <typename T, int CP>
cudaError_t launch_wide_dir(int inverse, const CUtensorMap& xm, void* out, const float* g,
                            const float* b, int n, int c, cudaStream_t s) {
  return inverse ? launch_wide<T, CP, true>(xm, out, g, b, n, c, s)
                 : launch_wide<T, CP, false>(xm, out, g, b, n, c, s);
}

template <typename T>
cudaError_t launch_width(int inverse, const CUtensorMap& xm, const CUtensorMap& om, void* out,
                         const float* g, const float* b, int n, int c, cudaStream_t s) {
  switch ((c + 63) / 64) {
    case 1: return launch_dir<T, 64>(inverse, xm, om, g, b, n, c, s);
    case 2: return launch_dir<T, 128>(inverse, xm, om, g, b, n, c, s);
    case 3: return launch_wide_dir<T, 192>(inverse, xm, out, g, b, n, c, s);
    default: return launch_wide_dir<T, 256>(inverse, xm, out, g, b, n, c, s);
  }
}

}  // namespace

// x, out: (n, c) contiguous, float32 (is_bf16 == 0) or bfloat16 (is_bf16 == 1),
// 16-byte aligned, with c * sizeof(x) a multiple of 16 (the wrapper pads other
// widths). gamma: (c, c) float32 [in -> out]; beta: (c,) float32. Launches on
// `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue without launching when n < 1, n >= 2^31 - 64,
// c < 1, c > 256, the row stride or alignment does not suit TMA, or the
// CUDA library gives no tensor-map encoder.
extern "C" int gdn_forward(const void* x, const void* gamma, const void* beta, void* out,
                           long long n, int c, int inverse, int is_bf16, void* stream) {
  const int esz = is_bf16 ? 2 : 4;
  if (n < 1 || n >= 0x7fffffffLL - ROWS || c < 1 || c > 256 || (c * esz) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the wide loop (c > 128) reads boxes of a whole tile and writes out without TMA
  const bool wide = c > 128;
  const int box_rows = wide ? wide_tile_rows(esz, c, WIDE_FORWARD) : ROWS;
  CUtensorMap x_map, out_map;
  if (!make_map(&x_map, const_cast<void*>(x), n, c, is_bf16 != 0, box_rows) ||
      (!wide && !make_map(&out_map, out, n, c, is_bf16 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const int rows = static_cast<int>(n);
  const cudaError_t err =
      is_bf16 ? launch_width<__nv_bfloat16>(inverse, x_map, out_map, out, g, b, rows, c, s)
              : launch_width<float>(inverse, x_map, out_map, out, g, b, rows, c, s);
  return static_cast<int>(err);
}
