// GDN / IGDN backward for Hopper (sm_90a): two tensor-core launches for the
// rows, then dgamma and dbeta in two CUDA-core launches.
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
// its products (x*x) . gamma, t . gamma^T and (x*x)^T . t are XLA's. Here
// they are this file's.
//
// What bounds it: device memory. The function reads x and g and writes dx,
// 3*N*C*sizeof(x) bytes, against three (N, C) x (C, C) products, 6*N*C^2
// operations, which the tensor cores (495 TFLOP/s TF32) run in less time
// than the bytes take (at N = 262,144, C = 128: 0.052 ms against 0.120 ms
// for float32 bytes). This design moves more than those bytes, because t
// (float32) is written once and read twice:
//   1. norm, gdn_bwd_norm_kernel: the forward's loop (csrc/gdn_wgmma.cuh)
//      over x tiles, n = beta + (x*x) . gamma on the tensor cores with P
//      planes (3xTF32 for float32 x, exact 3xbf16 for bfloat16 x, as the
//      forward); its epilogue reads g at the accumulator's positions and
//      writes t and d1 = g*r (g*s), float32. For float32 x, d1 goes into dx;
//      for bfloat16 x into a float32 scratch (rounding d1 to bf16 before the
//      second term would round dx twice).
//   2. mix, gdn_bwd_mix_kernel: the same loop over t tiles (float32, 3xTF32
//      for either type of x), u = t . gamma^T with Q planes (gamma[i][o] at
//      row i); its epilogue reads x and d1 and writes dx = d1 -+ x*u in x's
//      type.
//   3. dgamma partials: per (64 x 64 tile of dgamma, chunk of rows), the sum
//      of (x*x)^T . t over the chunk's rows, in row order; the blocks of the
//      first column of tiles also sum t over the rows (dbeta partials).
//   4. reduce: dgamma and dbeta as +-1/2 times the chunks' partials summed
//      in chunk order.
// Bytes per element of (N, C): float32 x 32 (launches 1-2) + 8 (launch 3),
// bfloat16 24 + 6, against 12 and 6 for the function itself. No atomics, so
// two runs give the same bits.
//
// Why two tensor-core launches: the products need gamma in two layouts, P
// (row o holds gamma[:, o]) for n and Q (row i holds gamma[i, :]) for u, and
// TF32 wgmma reads shared-memory B only K-major. Both layouts, each as hi and
// lo planes, take 4 * 64 KB at C = 128, above the 227 KB a block may use.
//
// Launches 1 and 2 read g, x and d1 and write t, d1 and dx straight from and
// to registers at the accumulator's positions (a thread's two neighbouring
// channels, four threads filling a 32-byte sector), not through TMA: beside
// gamma's planes, shared memory holds a single float32 stage of x and g
// together, too few for two warpgroups taking turns. Rows whose stride TMA
// cannot describe (C % 4 in float32, C % 8 in bfloat16, an unaligned base)
// are padded by the wrapper: zero gamma columns and x, g, unit beta, so the
// padded channels add nothing to dx, dgamma or dbeta.

#include "gdn_wgmma.cuh"

namespace {

constexpr int THREADS = 256;  // the partials and reduce launches
constexpr int TILE = 64;      // dgamma tile edge in the partials pass
constexpr int RSTEP = 32;     // rows staged per step of the partials pass

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// Two neighbouring channels of a row in device memory or a shared tile, as
// float32, and back.
__device__ __forceinline__ float2 widen(float2 v) { return v; }
__device__ __forceinline__ float2 widen(__nv_bfloat162 v) { return __bfloat1622float2(v); }
template <typename T>
using Pair = typename std::conditional<std::is_same<T, float>::value, float2,
                                       __nv_bfloat162>::type;
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// t and d1 from the norm n (n >= beta > 0): GDN t = g*x*r^3, d1 = g*r with
// r = rsqrt(n) (within 2 ulp); IGDN t = g*x/s, d1 = g*s with s = sqrt(n),
// rounded correctly, as the plain version computes them.
template <bool INVERSE>
__device__ __forceinline__ void terms(float n, float x, float g, float& t, float& d1) {
  if (INVERSE) {
    const float s = sqrtf(n);
    t = g * x / s;
    d1 = g * s;
  } else {
    const float r = rsqrtf(n);
    t = g * x * (r * r * r);
    d1 = g * r;
  }
}

// Launch 1's epilogue: x from the shared tile, g from device memory; t and
// d1 (float32) out. Accumulator element 4j + 2h + e: row row0 + ra + 8h,
// channel n0 + 8j + 2*t4 + e.
template <typename T, int CP, bool INVERSE>
struct NormEpilogue {
  const T* g;
  float* t;
  float* d1;
  int n_rows, c;

  __device__ __forceinline__ void operator()(uint8_t* tile, const float* acc,
                                             const float* beta_s, int row0, int n0, int ra,
                                             int t4) const {
    using K = Cfg<T, CP>;
    // channel pairs loaded before any is computed and stored: loads in flight
    // to cover device memory's latency, in few enough registers
    constexpr int JG = K::NB / 8 < 8 ? K::NB / 8 : 8;
#pragma unroll
    for (int j0 = 0; j0 < K::NB / 8; j0 += JG) {
      Pair<T> gv[JG][2];
#pragma unroll
      for (int j = 0; j < JG; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = n0 + 8 * (j0 + j) + 2 * t4;
          const int row = row0 + ra + 8 * h;
          if (row < n_rows && col < c) {
            gv[j][h] = *reinterpret_cast<const Pair<T>*>(g + static_cast<int64_t>(row) * c + col);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < JG; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = n0 + 8 * (j0 + j) + 2 * t4;
          const int row = row0 + ra + 8 * h;
          if (row < n_rows && col < c) {
            const Pair<T> xr = *reinterpret_cast<const Pair<T>*>(
                tile + (col / K::COLS) * BOX_TILE_BYTES + swz(ra + 8 * h, (col % K::COLS) * K::ESZ));
            const float2 xv = widen(xr), gf = widen(gv[j][h]);
            const int v = 4 * (j0 + j) + 2 * h;
            float t0, t1, d0, d1v;
            terms<INVERSE>(acc[v] + beta_s[col - n0], xv.x, gf.x, t0, d0);
            terms<INVERSE>(acc[v + 1] + beta_s[col - n0 + 1], xv.y, gf.y, t1, d1v);
            const int64_t off = static_cast<int64_t>(row) * c + col;
            store_pair(t + off, t0, t1);
            store_pair(d1 + off, d0, d1v);
          }
        }
      }
    }
  }
};

// Launch 2's epilogue: u = t . gamma^T in the accumulator; x and d1 from
// device memory; dx = d1 - x*u (GDN) or d1 + x*u (IGDN) out, in x's type.
// For float32 x, d1 is dx itself: each element is read and then written by
// the same thread.
template <typename T, int CP, bool INVERSE>
struct MixEpilogue {
  const T* x;
  const float* d1;
  T* dx;
  int n_rows, c;

  __device__ __forceinline__ void operator()(uint8_t*, const float* acc, const float*,
                                             int row0, int n0, int ra, int t4) const {
    using K = Cfg<float, CP>;
    // channel pairs loaded before any is computed and stored: loads in flight
    // to cover device memory's latency, in few enough registers
    constexpr int JG = K::NB / 8 < 8 ? K::NB / 8 : 8;
#pragma unroll
    for (int j0 = 0; j0 < K::NB / 8; j0 += JG) {
      Pair<T> xv[JG][2];
      float2 dv[JG][2];
#pragma unroll
      for (int j = 0; j < JG; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = n0 + 8 * (j0 + j) + 2 * t4;
          const int row = row0 + ra + 8 * h;
          if (row < n_rows && col < c) {
            const int64_t off = static_cast<int64_t>(row) * c + col;
            xv[j][h] = *reinterpret_cast<const Pair<T>*>(x + off);
            dv[j][h] = *reinterpret_cast<const float2*>(d1 + off);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < JG; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int col = n0 + 8 * (j0 + j) + 2 * t4;
          const int row = row0 + ra + 8 * h;
          if (row < n_rows && col < c) {
            const float2 xf = widen(xv[j][h]);
            const int v = 4 * (j0 + j) + 2 * h;
            const float s = INVERSE ? 1.0f : -1.0f;
            store_pair(dx + static_cast<int64_t>(row) * c + col, dv[j][h].x + s * xf.x * acc[v],
                       dv[j][h].y + s * xf.y * acc[v + 1]);
          }
        }
      }
    }
  }
};

// Launch 1. x: (n_rows, c) through x_map; t, d1: (n_rows, c) float32.
template <typename T, int CP, bool INVERSE>
__global__ void __launch_bounds__(Cfg<T, CP>::THREADS, 1)
gdn_bwd_norm_kernel(const __grid_constant__ CUtensorMap x_map, const T* __restrict__ g,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    float* __restrict__ t, float* __restrict__ d1, int n_rows, int c) {
  mix_rows<T, CP, false, false>(&x_map, nullptr, gamma, beta, n_rows, c,
                                NormEpilogue<T, CP, INVERSE>{g, t, d1, n_rows, c});
}

// Launch 2. t: (n_rows, c) float32 through t_map; x, dx: (n_rows, c) in x's
// type; d1 float32 (dx itself for float32 x, so neither is __restrict__).
template <typename T, int CP, bool INVERSE>
__global__ void __launch_bounds__(Cfg<float, CP>::THREADS, 1)
gdn_bwd_mix_kernel(const __grid_constant__ CUtensorMap t_map, const T* __restrict__ x,
                   const float* __restrict__ gamma, const float* d1, T* dx, int n_rows, int c) {
  mix_rows<float, CP, true, false>(&t_map, nullptr, gamma, nullptr, n_rows, c,
                                   MixEpilogue<T, CP, INVERSE>{x, d1, dx, n_rows, c});
}

// Launch 3. Block (blockIdx.x, blockIdx.y) owns dgamma[i0 : i0+64][o0 : o0+64],
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

// Launch 4. One thread per element of dgamma (then dbeta): the chunks' partials
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

// The two tensor-core launches' arguments.
template <typename T>
struct RowsArgs {
  CUtensorMap x_map, t_map;
  const T* x;
  const T* g;
  const float* gamma;
  const float* beta;
  T* dx;
  float* t;
  float* d1;
  int n, c;
};

template <typename T, int CP, bool INVERSE>
cudaError_t launch_rows(const RowsArgs<T>& a, cudaStream_t stream) {
  static int norm_sms[MAX_DEVICES] = {}, mix_sms[MAX_DEVICES] = {};
  const cudaError_t err = launch_persistent<Cfg<T, CP>>(
      gdn_bwd_norm_kernel<T, CP, INVERSE>, norm_sms, a.n, stream, a.x_map, a.g, a.gamma, a.beta,
      a.t, a.d1, a.n, a.c);
  if (err != cudaSuccess) return err;
  return launch_persistent<Cfg<float, CP>>(gdn_bwd_mix_kernel<T, CP, INVERSE>, mix_sms, a.n,
                                           stream, a.t_map, a.x, a.gamma,
                                           static_cast<const float*>(a.d1), a.dx, a.n, a.c);
}

template <typename T, int CP>
cudaError_t launch_rows_dir(int inverse, const RowsArgs<T>& a, cudaStream_t s) {
  return inverse ? launch_rows<T, CP, true>(a, s) : launch_rows<T, CP, false>(a, s);
}

template <typename T>
cudaError_t launch_all(const RowsArgs<T>& a, float* dgamma, float* dbeta, float* part,
                       int chunk_rows, int chunks, int inverse, cudaStream_t stream) {
  cudaError_t err;
  switch ((a.c + 63) / 64) {
    case 1: err = launch_rows_dir<T, 64>(inverse, a, stream); break;
    case 2: err = launch_rows_dir<T, 128>(inverse, a, stream); break;
    case 3: err = launch_rows_dir<T, 192>(inverse, a, stream); break;
    default: err = launch_rows_dir<T, 256>(inverse, a, stream); break;
  }
  if (err != cudaSuccess || dgamma == nullptr) return err;
  const int c = a.c;
  const unsigned tiles = static_cast<unsigned>((c + TILE - 1) / TILE);
  gdn_bwd_partials_kernel<T><<<dim3(tiles, tiles, static_cast<unsigned>(chunks)), THREADS, 0,
                               stream>>>(a.x, a.t, part, a.n, c, chunk_rows, chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const int64_t outs = static_cast<int64_t>(c) * c + c;
  gdn_bwd_reduce_kernel<<<static_cast<unsigned>((outs + THREADS - 1) / THREADS), THREADS, 0,
                          stream>>>(part, dgamma, dbeta, c, chunks, inverse ? 0.5f : -0.5f);
  return cudaGetLastError();
}

template <typename T>
int run(const void* x, const void* g, const void* gamma, const void* beta, void* dx,
        void* dgamma, void* dbeta, void* scratch, long long n, int c, int chunk_rows,
        int chunks, int inverse, cudaStream_t stream) {
  RowsArgs<T> a;
  a.x = static_cast<const T*>(x);
  a.g = static_cast<const T*>(g);
  a.gamma = static_cast<const float*>(gamma);
  a.beta = static_cast<const float*>(beta);
  a.dx = static_cast<T*>(dx);
  a.t = static_cast<float*>(scratch);
  const bool is_bf16 = std::is_same<T, __nv_bfloat16>::value;
  a.d1 = is_bf16 ? a.t + n * c : static_cast<float*>(dx);
  float* part = a.t + n * c * (is_bf16 ? 2 : 1);
  a.n = static_cast<int>(n);
  a.c = c;
  if (!make_map(&a.x_map, const_cast<void*>(x), n, c, is_bf16) ||
      !make_map(&a.t_map, a.t, n, c, false)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_all<T>(a, static_cast<float*>(dgamma),
                                        static_cast<float*>(dbeta), part, chunk_rows, chunks,
                                        inverse, stream));
}

}  // namespace

// x, g, dx: (n, c) contiguous, float32 (is_bf16 == 0) or bfloat16 (is_bf16 ==
// 1), dx in x's type, 16-byte aligned, with c * sizeof(x) a multiple of 16
// (the wrapper pads other widths); gamma (c, c) [in -> out] and beta (c,)
// float32, already reparametrized; dgamma (c, c) and dbeta (c,) float32 out.
// scratch: 16-byte aligned float32, t (n, c), then for bfloat16 d1 (n, c),
// then the partials (chunks * c * c + chunks * c), with chunks =
// ceil(n / chunk_rows). dgamma and dbeta null (both) skip the dgamma/dbeta
// stage, launches 3 and 4, and the scratch then ends after t (and d1).
// Launches four kernels (two without dgamma) on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue without
// launching when n < 1, n >= 2^31 - 64, c < 1, c > 256, the row stride or an
// alignment does not suit TMA, chunk_rows < 1, chunks is not
// ceil(n / chunk_rows) or exceeds 65,535, or the CUDA library gives no
// tensor-map encoder.
extern "C" int gdn_backward(const void* x, const void* g, const void* gamma, const void* beta,
                            void* dx, void* dgamma, void* dbeta, void* scratch, long long n,
                            int c, int chunk_rows, int chunks, int inverse, int is_bf16,
                            void* stream) {
  const int esz = is_bf16 ? 2 : 4;
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (n < 1 || n >= 0x7fffffffLL - ROWS || c < 1 || c > 256 || (c * esz) % 16 != 0 ||
      misaligned(x) || misaligned(g) || misaligned(dx) || misaligned(scratch) ||
      chunk_rows < 1 || chunks > 65535 || (dgamma == nullptr) != (dbeta == nullptr) ||
      static_cast<long long>(chunks) != (n + chunk_rows - 1) / chunk_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? run<__nv_bfloat16>(x, g, gamma, beta, dx, dgamma, dbeta, scratch, n, c,
                                      chunk_rows, chunks, inverse, s)
                 : run<float>(x, g, gamma, beta, dx, dgamma, dbeta, scratch, n, c, chunk_rows,
                              chunks, inverse, s);
}
