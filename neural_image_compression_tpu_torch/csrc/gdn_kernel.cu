// GDN / IGDN forward for Hopper (sm_90a).
//
//   out[n, o] = x[n, o] * rsqrt(beta[o] + sum_i x[n, i]^2 * gamma[i, o])   (GDN)
//   out[n, o] = x[n, o] * sqrt (beta[o] + sum_i x[n, i]^2 * gamma[i, o])   (IGDN)
//
// Replaces the Pallas TPU kernel neural_image_compression_tpu/ops/pallas/
// gdn_kernel.py (`_kernel`, launched by `fused_gdn`). gamma is (C_in, C_out)
// and beta is (C,), both already reparametrized (ops/bound.nonneg) by the
// caller. x and out are (N, C) row-major rows of an NHWC activation, float32
// or bfloat16; all arithmetic is float32 and the result is written in x's
// type directly (no float32 intermediate in device memory).
//
// What bounds it: the channel mix is an (N, C) x (C, C) product, 2*N*C^2
// operations against 2*N*C*sizeof(x) bytes. At C = 128 that is 64 (float32)
// or 128 (bfloat16) operations per byte, above the card's float32 balance
// point (67 TFLOP/s over 3.35 TB/s = 20), so a float32 FMA kernel is bound by
// operations, not by memory.
//
// Design (simple first): a register-tiled float32 GEMM whose prologue squares
// x on its way into shared memory and whose epilogue adds beta, takes
// rsqrt/sqrt and multiplies by x. Each block owns a BM x BN output tile and
// walks the input channels in BK slices through shared memory; each of its
// 256 threads accumulates a TM x TN micro-tile in registers. Blocks that share
// a row tile are launched next to each other (1-D grid, channel tile fastest)
// so the second read of an x tile hits L2. The ragged row and channel edges
// are masked in the kernel; the wrapper pads nothing. C is limited by nothing
// but int range: shared memory holds one BK slice, not the whole gamma.
// A tensor-core (wgmma/TF32) version is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;   // rows per block tile
constexpr int BN = 64;   // output channels per block tile
constexpr int BK = 16;   // input channels per shared-memory slice
constexpr int TM = 4;    // rows per thread
constexpr int TN = 4;    // output channels per thread
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, bool INVERSE>
__global__ void __launch_bounds__(THREADS)
gdn_rows_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, T* __restrict__ out,
                int64_t n, int c, int col_tiles) {
  // x^2 slice stored k-major so the inner loop reads a column of rows;
  // the +1 pad spreads the transposing stores over the banks.
  __shared__ float xs[BK][BM + 1];
  __shared__ float gs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // channel lane: 0..15
  const int ty = tid / (BN / TN);  // row lane: 0..15
  const int64_t row0 = (int64_t)(blockIdx.x / col_tiles) * BM;
  const int col0 = (blockIdx.x % col_tiles) * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < c; k0 += BK) {
    // x slice: BM x BK values; 16 neighbouring threads read one row's BK
    // neighbouring channels.
#pragma unroll
    for (int l = 0; l < (BM * BK) / THREADS; ++l) {
      const int e = tid + l * THREADS;
      const int r = e / BK;
      const int kk = e % BK;
      const int64_t gr = row0 + r;
      const int gk = k0 + kk;
      float v = 0.0f;
      if (gr < n && gk < c) v = load_f32(x + gr * c + gk);
      xs[kk][r] = v * v;
    }
    // gamma slice: BK x BN values, one row of BN channels per 64 threads.
#pragma unroll
    for (int l = 0; l < (BK * BN) / THREADS; ++l) {
      const int e = tid + l * THREADS;
      const int kk = e / BN;
      const int cc = e % BN;
      const int gk = k0 + kk;
      const int gc = col0 + cc;
      gs[kk][cc] = (gk < c && gc < c) ? gamma[(int64_t)gk * c + gc] : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = gs[kk][tx + j * (BN / TN)];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t r = row0 + ty + i * (BM / TM);
    if (r >= n) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tx + j * (BN / TN);
      if (col >= c) continue;
      const float norm = acc[i][j] + beta[col];
      const float xv = load_f32(x + r * c + col);
      store_as(out + r * c + col, INVERSE ? xv * sqrtf(norm) : xv * rsqrtf(norm));
    }
  }
}

template <typename T>
void launch(const void* x, const float* gamma, const float* beta, void* out,
            int64_t n, int c, int inverse, cudaStream_t stream) {
  const int col_tiles = (c + BN - 1) / BN;
  const int64_t row_tiles = (n + BM - 1) / BM;
  const dim3 grid((unsigned)(row_tiles * col_tiles));
  if (inverse) {
    gdn_rows_kernel<T, true><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), gamma, beta, static_cast<T*>(out), n, c, col_tiles);
  } else {
    gdn_rows_kernel<T, false><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x), gamma, beta, static_cast<T*>(out), n, c, col_tiles);
  }
}

}  // namespace

// x, out: (n, c) contiguous, float32 (is_bf16 == 0) or bfloat16 (is_bf16 == 1).
// gamma: (c, c) float32 [in -> out]; beta: (c,) float32. Launches on `stream`
// and returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// without launching when n < 1, c < 1 or the grid would exceed 2^31 - 1 blocks.
extern "C" int gdn_forward(const void* x, const void* gamma, const void* beta,
                           void* out, long long n, int c, int inverse,
                           int is_bf16, void* stream) {
  const long long blocks = ((n + BM - 1) / BM) * ((c + BN - 1) / BN);
  if (n < 1 || c < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  if (is_bf16) {
    launch<__nv_bfloat16>(x, g, b, out, (int64_t)n, c, inverse, s);
  } else {
    launch<float>(x, g, b, out, (int64_t)n, c, inverse, s);
  }
  return (int)cudaGetLastError();
}
