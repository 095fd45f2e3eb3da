// GDN / IGDN backward for Hopper (sm_90a): CUDA-core kernels.
//
// The forward (csrc/gdn_kernel.cu) is out = x * r with r = n^(-1/2) (GDN) or
// out = x * s with s = n^(1/2) (IGDN), n = beta + (x*x) . gamma, gamma
// (C_in, C_out). Given g = dL/dout, with n recomputed from x:
//   GDN:  t = g*x*r^3,  dx = g*r - x*(t . gamma^T),  dgamma = -1/2 (x*x)^T . t,  dbeta = -1/2 sum_rows t
//   IGDN: t = g*x/s,    dx = g*s + x*(t . gamma^T),  dgamma = +1/2 (x*x)^T . t,  dbeta = +1/2 sum_rows t
//
// Replaces the backward of the Pallas TPU kernel neural_image_compression_tpu/
// ops/pallas/gdn_kernel.py (`gdn_fused_op`), which is XLA autodiff of
// `_gdn_reference` (`_gdn_bwd`): the JAX package has no Pallas backward, and
// its products (x*x)^T . t and t . gamma^T are XLA's. Here they are this
// file's.
//
// What bounds it: device memory. x and g are read and dx written once,
// 3*N*C*sizeof(x) bytes, against three (N, C) x (C, C) products, 6*N*C^2
// operations, which the card's tensor cores could run in less time than the
// bytes take (at N = 262,144, C = 128: 0.052 ms at the TF32 rate against
// 0.120 ms for float32 bytes). This first design runs the products on the
// CUDA cores in float32 (67 TFLOP/s), so it is bound by those operations
// and the shared-memory loads that feed them, several times above the bytes
// bound: a kernel that is right first; the tensor cores are a later design.
//
// Design, three launches on the caller's stream, no atomics, so two runs
// give the same bits:
//   1. rows: one block per 64-row tile. x and g go to shared memory as
//      float32 (the tile is 64*C consecutive elements: coalesced for any C,
//      no padding of the rows). n = beta + (x*x) . gamma and u = t . gamma^T
//      are register-tiled float32 products (8 rows x C/32 columns a thread)
//      over gamma staged 32 rows (or columns) at a time; the block writes dx
//      and t (float32, scratch).
//   2. dgamma partials: per (64 x 64 tile of dgamma, chunk of rows), the sum
//      of (x*x)^T . t over the chunk's rows, in row order; the blocks of the
//      first column of tiles also sum t over the rows (dbeta partials).
//   3. reduce: dgamma and dbeta as +-1/2 times the chunks' partials summed
//      in chunk order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS = 64;   // rows per tile of the row pass: 8 a thread, 8 warps
constexpr int KC = 32;     // gamma rows (product 1) or columns (product 2) staged per step
constexpr int TILE = 64;   // dgamma tile edge in the partials pass
constexpr int RSTEP = 32;  // rows staged per step of the partials pass
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <int JN>
constexpr int rows_smem_bytes() {
  return (2 * ROWS + KC) * (32 * JN + 1) * 4;
}

// Pass 1. CP = 32 * JN is C rounded up to a multiple of 32; the shared tiles
// have rows of CP + 1 floats, so a warp that walks a column (gamma^T's
// staging, product 2's reads) hits 32 different banks.
template <typename T, int JN>
__global__ void __launch_bounds__(THREADS)
gdn_bwd_rows_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    T* __restrict__ dx, float* __restrict__ t_out, int64_t n_rows, int c,
                    int inverse) {
  constexpr int CP = 32 * JN;
  constexpr int LD = CP + 1;
  extern __shared__ float smem[];
  float* xs = smem;              // [ROWS][LD] x
  float* ts = xs + ROWS * LD;    // [ROWS][LD] g, then t
  float* gs = ts + ROWS * LD;    // [KC][LD]   a slab of gamma (or gamma^T)

  const int tid = threadIdx.x;
  const int tx = tid % 32;       // columns tx + 32 j
  const int r0 = (tid / 32) * 8; // rows r0 .. r0 + 7 (one warp: the same rows)
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * ROWS;
  const int rows = static_cast<int>(n_rows - row0 < ROWS ? n_rows - row0 : ROWS);
  const int64_t base = row0 * c;

  for (int e = tid; e < ROWS * CP; e += THREADS) {
    const int r = e / CP, k = e % CP;
    const bool in = r < rows && k < c;
    xs[r * LD + k] = in ? to_f32(x[base + static_cast<int64_t>(r) * c + k]) : 0.0f;
    ts[r * LD + k] = in ? to_f32(g[base + static_cast<int64_t>(r) * c + k]) : 0.0f;
  }

  // product 1: n[r][o] - beta[o] = sum_k x[r][k]^2 gamma[k][o]
  float acc[8][JN];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < JN; ++j) acc[i][j] = 0.0f;
  }
  for (int k0 = 0; k0 < CP; k0 += KC) {
    __syncthreads();  // the tiles are written; the previous slab is consumed
    for (int e = tid; e < KC * CP; e += THREADS) {
      const int kk = e / CP, o = e % CP;
      const int k = k0 + kk;
      gs[kk * LD + o] = (k < c && o < c) ? gamma[static_cast<int64_t>(k) * c + o] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      float s[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float v = xs[(r0 + i) * LD + k0 + kk];
        s[i] = v * v;
      }
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        const float gv = gs[kk * LD + tx + 32 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(s[i], gv, acc[i][j]);
      }
    }
  }

  // t and the first term of dx, for this thread's own elements
  float d1[8][JN];
#pragma unroll
  for (int j = 0; j < JN; ++j) {
    const int o = tx + 32 * j;
    const float b = o < c ? beta[o] : 1.0f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = r0 + i;
      const float norm = acc[i][j] + b;
      const float xv = xs[r * LD + o], gv = ts[r * LD + o];
      float t;
      if (inverse) {
        const float root = sqrtf(norm);
        t = gv * xv / root;
        d1[i][j] = gv * root;
      } else {
        const float rr = rsqrtf(norm);
        t = gv * xv * (rr * rr * rr);
        d1[i][j] = gv * rr;
      }
      ts[r * LD + o] = t;
      if (r < rows && o < c) t_out[base + static_cast<int64_t>(r) * c + o] = t;
    }
  }

  // product 2: u[r][i] = sum_o t[r][o] gamma[i][o]
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < JN; ++j) acc[i][j] = 0.0f;
  }
  for (int o0 = 0; o0 < CP; o0 += KC) {
    __syncthreads();  // t is written; the previous slab is consumed
    for (int e = tid; e < KC * CP; e += THREADS) {
      const int ic = e / KC, oo = e % KC;  // a warp reads 32 consecutive o of one gamma row
      const int o = o0 + oo;
      gs[oo * LD + ic] = (ic < c && o < c) ? gamma[static_cast<int64_t>(ic) * c + o] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int oo = 0; oo < KC; ++oo) {
      float tv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) tv[i] = ts[(r0 + i) * LD + o0 + oo];
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        const float gv = gs[oo * LD + tx + 32 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(tv[i], gv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < JN; ++j) {
    const int ic = tx + 32 * j;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = r0 + i;
      if (r < rows && ic < c) {
        const float xu = xs[r * LD + ic] * acc[i][j];
        store(dx + base + static_cast<int64_t>(r) * c + ic, inverse ? d1[i][j] + xu : d1[i][j] - xu);
      }
    }
  }
}

// Pass 2. Block (blockIdx.x, blockIdx.y) owns dgamma[i0 : i0+64][o0 : o0+64],
// blockIdx.z a chunk of chunk_rows rows. A thread sums 4 x 4 elements
// (i = i0 + 4 ty + a, o = o0 + tx + 16 b) over the chunk's rows in order.
// part: [chunks][c][c] dgamma partials, then [chunks][c] dbeta partials.
template <typename T>
__global__ void __launch_bounds__(THREADS)
gdn_bwd_partials_kernel(const T* __restrict__ x, const float* __restrict__ t,
                        float* __restrict__ part, int64_t n_rows, int c, int chunk_rows,
                        int chunks) {
  __shared__ float ss[RSTEP][TILE + 1];  // x^2 of the staged rows, inputs i0 ..
  __shared__ float tt[RSTEP][TILE + 1];  // t of the staged rows, outputs o0 ..
  const int i0 = blockIdx.x * TILE, o0 = blockIdx.y * TILE;
  const int64_t r_begin = static_cast<int64_t>(blockIdx.z) * chunk_rows;
  const int64_t r_end = r_begin + chunk_rows < n_rows ? r_begin + chunk_rows : n_rows;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[4][4], bsum[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    bsum[b] = 0.0f;
#pragma unroll
    for (int a = 0; a < 4; ++a) acc[a][b] = 0.0f;
  }
  for (int64_t rs = r_begin; rs < r_end; rs += RSTEP) {
    __syncthreads();
    for (int e = tid; e < RSTEP * TILE; e += THREADS) {
      const int rr = e / TILE, k = e % TILE;
      const int64_t row = rs + rr;
      const bool in = row < r_end;
      const float xv = (in && i0 + k < c) ? to_f32(x[row * c + i0 + k]) : 0.0f;
      ss[rr][k] = xv * xv;
      tt[rr][k] = (in && o0 + k < c) ? t[row * c + o0 + k] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < RSTEP; ++rr) {
      float sv[4], tv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) sv[a] = ss[rr][4 * ty + a];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        tv[b] = tt[rr][tx + 16 * b];
        bsum[b] += tv[b];
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(sv[a], tv[b], acc[a][b]);
      }
    }
  }
  const int64_t cc = static_cast<int64_t>(c) * c;
  float* pg = part + blockIdx.z * cc;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + 4 * ty + a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int o = o0 + tx + 16 * b;
      if (i < c && o < c) pg[static_cast<int64_t>(i) * c + o] = acc[a][b];
    }
  }
  if (blockIdx.x == 0 && ty == 0) {
    float* pb = part + chunks * cc + static_cast<int64_t>(blockIdx.z) * c;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int o = o0 + tx + 16 * b;
      if (o < c) pb[o] = bsum[b];
    }
  }
}

// Pass 3. One thread per element of dgamma (then dbeta): the chunks' partials
// summed in chunk order, times +-1/2.
__global__ void __launch_bounds__(THREADS)
gdn_bwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ dgamma,
                      float* __restrict__ dbeta, int c, int chunks, float half) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int64_t cc = static_cast<int64_t>(c) * c;
  if (idx < cc) {
    float s = 0.0f;
    for (int z = 0; z < chunks; ++z) s += part[z * cc + idx];
    dgamma[idx] = half * s;
  } else if (idx < cc + c) {
    const int64_t o = idx - cc;
    const float* pb = part + chunks * cc;
    float s = 0.0f;
    for (int z = 0; z < chunks; ++z) s += pb[z * c + o];
    dbeta[o] = half * s;
  }
}

template <typename T, int JN>
cudaError_t launch_rows(const T* x, const T* g, const float* gamma, const float* beta, T* dx,
                        float* t, int64_t n, int c, int inverse, cudaStream_t stream) {
  auto kernel = gdn_bwd_rows_kernel<T, JN>;
  constexpr int SMEM = rows_smem_bytes<JN>();
  // per device, once: above 48 KB of shared memory a kernel must opt in
  static bool ready[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!ready[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return err;
    ready[dev] = true;
  }
  const int64_t blocks = (n + ROWS - 1) / ROWS;
  kernel<<<static_cast<unsigned>(blocks), THREADS, SMEM, stream>>>(x, g, gamma, beta, dx, t, n,
                                                                   c, inverse);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_all(const void* x, const void* g, const float* gamma, const float* beta,
                       void* dx, float* dgamma, float* dbeta, float* t, float* part, int64_t n,
                       int c, int chunk_rows, int chunks, int inverse, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  T* dxt = static_cast<T*>(dx);
  cudaError_t err;
  switch ((c + 31) / 32) {
    case 1: err = launch_rows<T, 1>(xt, gt, gamma, beta, dxt, t, n, c, inverse, stream); break;
    case 2: err = launch_rows<T, 2>(xt, gt, gamma, beta, dxt, t, n, c, inverse, stream); break;
    case 3: err = launch_rows<T, 3>(xt, gt, gamma, beta, dxt, t, n, c, inverse, stream); break;
    case 4: err = launch_rows<T, 4>(xt, gt, gamma, beta, dxt, t, n, c, inverse, stream); break;
    case 5: err = launch_rows<T, 5>(xt, gt, gamma, beta, dxt, t, n, c, inverse, stream); break;
    case 6: err = launch_rows<T, 6>(xt, gt, gamma, beta, dxt, t, n, c, inverse, stream); break;
    case 7: err = launch_rows<T, 7>(xt, gt, gamma, beta, dxt, t, n, c, inverse, stream); break;
    default: err = launch_rows<T, 8>(xt, gt, gamma, beta, dxt, t, n, c, inverse, stream); break;
  }
  if (err != cudaSuccess) return err;
  const unsigned tiles = static_cast<unsigned>((c + TILE - 1) / TILE);
  gdn_bwd_partials_kernel<T><<<dim3(tiles, tiles, static_cast<unsigned>(chunks)), THREADS, 0,
                               stream>>>(xt, t, part, n, c, chunk_rows, chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t outs = static_cast<int64_t>(c) * c + c;
  gdn_bwd_reduce_kernel<<<static_cast<unsigned>((outs + THREADS - 1) / THREADS), THREADS, 0,
                          stream>>>(part, dgamma, dbeta, c, chunks, inverse ? 0.5f : -0.5f);
  return cudaGetLastError();
}

}  // namespace

// x, g, dx: (n, c) contiguous, float32 (is_bf16 == 0) or bfloat16 (is_bf16 ==
// 1), dx in x's type; gamma (c, c) [in -> out] and beta (c,) float32, already
// reparametrized; dgamma (c, c) and dbeta (c,) float32 out. Scratch, float32:
// t (n, c) and part (chunks * c * c + chunks * c) with chunks =
// ceil(n / chunk_rows). Launches three kernels on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue without
// launching when n < 1, c < 1, c > 256, chunk_rows < 1 or chunks is not
// ceil(n / chunk_rows) or exceeds 65,535.
extern "C" int gdn_backward(const void* x, const void* g, const void* gamma, const void* beta,
                            void* dx, void* dgamma, void* dbeta, void* t, void* part,
                            long long n, int c, int chunk_rows, int chunks, int inverse,
                            int is_bf16, void* stream) {
  if (n < 1 || c < 1 || c > 256 || chunk_rows < 1 || chunks > 65535 ||
      static_cast<long long>(chunks) != (n + chunk_rows - 1) / chunk_rows ||
      (n + ROWS - 1) / ROWS > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  float* dg = static_cast<float*>(dgamma);
  float* db = static_cast<float*>(dbeta);
  float* tt = static_cast<float*>(t);
  float* pp = static_cast<float*>(part);
  const cudaError_t err =
      is_bf16 ? launch_all<__nv_bfloat16>(x, g, ga, be, dx, dg, db, tt, pp, n, c, chunk_rows,
                                          chunks, inverse, s)
              : launch_all<float>(x, g, ga, be, dx, dg, db, tt, pp, n, c, chunk_rows, chunks,
                                  inverse, s);
  return static_cast<int>(err);
}
