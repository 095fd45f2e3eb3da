// GDN / IGDN backward for Hopper (sm_90a): three or four launches, all but
// the last on the tensor cores.
//
// The forward (csrc/gdn_kernel.cu) is out = x * r with r = n^(-1/2) (GDN) or
// out = x * s with s = n^(1/2) (IGDN), n = beta + (x*x) . gamma, gamma
// (C_in, C_out). Given g = dL/dout, with n recomputed from x:
//   GDN:  t = g*x*r^3,  dx = g*r - x*(t . gamma^T),
//         dgamma = -1/2 (x*x)^T . t,  dbeta = -1/2 sum_rows t
//   IGDN: t = g*x/s,    dx = g*s + x*(t . gamma^T),
//         dgamma = +1/2 (x*x)^T . t,  dbeta = +1/2 sum_rows t
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
// for float32 bytes). dx comes from two products, n (the norm) and u = t .
// gamma^T (the mix), with t between them:
//   1-2, from 65 to 128 channels (CP = 128, the flagship's width): one
//      fused launch, gdn_bwd_fused_kernel, on csrc/gdn_wide.cuh's cluster
//      loop. A cluster of two blocks walks 128-row tiles of x (multicast
//      once per cluster); block rank r owns channels [64 r, 64 r + 64) as
//      the norm's outputs and as the mix's, and holds both of gamma's
//      layouts for them. Its consumers take n on the tensor cores with P
//      planes (3xTF32 for float32 x, exact 3xbf16 for bfloat16 x, as the
//      forward), then t and d1 = g*r (g*s, s = n*r) from one r = rsqrt(n)
//      (`terms`) in registers, g read at the accumulator's positions; t
//      goes to the partner block (st.async into its shared memory), and u
//      for the block's channels over all 128 runs on the tensor cores from
//      registers (3xTF32, Q planes: the block's own t from its accumulator,
//      the partner's from the exchange); dx = d1 -+ x*u out in x's type. t
//      is written to device memory (float32) only for launch 3; d1 never.
//      Both products run over k in the two launches' box and k-step order,
//      so dx, dgamma and dbeta keep their bits. Bound by its bytes.
//   1-2, at the other widths: two launches, t and d1 through device memory.
//      1. norm: the forward's loop over x tiles (at C <= 64
//         gdn_bwd_norm_kernel on csrc/gdn_wgmma.cuh's mix_rows; at 192 and
//         256 gdn_bwd_norm_kernel_cluster on csrc/gdn_wide.cuh's cluster
//         loop), n as above; its epilogue reads g at the accumulator's
//         positions and writes t and d1, float32, from one r = rsqrt(n).
//         For float32 x, d1 goes into dx; for bfloat16 x into a float32
//         scratch (rounding d1 to bf16 before the second term would round
//         dx twice). Bound by its bytes.
//      2. mix (gdn_bwd_mix_kernel, gdn_bwd_mix_kernel_cluster): the same
//         loops over t tiles (float32, 3xTF32 for either type of x), u = t .
//         gamma^T with Q planes (gamma[i][o] at row i); its epilogue reads x
//         and d1 and writes dx = d1 -+ x*u in x's type. Bound by its bytes.
//   3. partials, gdn_bwd_partials_kernel: per (chunk of rows, tile of
//      dgamma), (x*x)^T . t over the chunk's rows as 3xTF32 products on the
//      tensor cores (wgmma, float32 accumulate); the blocks of the first
//      row of tiles also sum t over the rows (dbeta partials). A ring of
//      32-row x and t tiles comes in through TMA; the threads write each t
//      tile, split into TF32 hi and lo, once into K-major planes (B), while
//      the previous tile's products run; each warpgroup squares and splits
//      its 64 inputs of x in registers (A). At C = 128 its bytes bound it
//      (the split products take about 60% of their time at the TF32 peak);
//      at C = 192 and 256 the operations come close to the bytes.
//   4. reduce: dgamma and dbeta as +-1/2 times the chunks' partials summed
//      in chunk order, on the CUDA cores. Bound by the partials' bytes.
// Bytes per element of (N, C), launches 1-2: from 65 to 128 channels 12
// (float32 x: x, g in, dx out) or 6 (bfloat16), plus 4 for t with the
// dgamma/dbeta stage; at the other widths 32 (float32) or 24 (bfloat16);
// against 12 and 6 for the function itself. Launch 3 adds 8 (float32 x) or
// 6 (x and t read once; at C = 192 x three times and at C = 256 both twice,
// mostly from L2); launches 3 and 4 add chunks * C * (C + 1) * 4 twice. No
// atomics, and every sum runs in a fixed order for a given shape (the
// chunks are a function of N), so two runs give the same bits.
//
// Why two tensor-core launches at C <= 64 and C = 192, 256: the products
// need gamma in two layouts, P (row o holds gamma[:, o]) for n and Q (row i
// holds gamma[i, :]) for u, and TF32 wgmma reads shared-memory B only
// K-major. One block holds both layouts of all 128 channels only at 4 * 64
// KB (hi and lo planes, float32), above the 227 KB a block may use; the
// fused launch cuts them in two across its cluster (4 * 32 KB a block at
// float32). At C = 192 and 256 both layouts would need clusters of 4 and 8;
// at C <= 64 (test widths) the two launches stay.
//
// Why launch 3 writes t into planes: its product runs over rows, so K is
// the slow index of both x and t as they sit in device memory and in the
// TMA tiles, and TF32 wgmma reads shared-memory operands only K-major. A
// from registers takes any layout, so each warpgroup loads x^2's fragments
// straight from the row tile; B, t, must be K-major in shared memory, so
// the block transposes it, three buffers taking turns. The k slots t and
// t + 4 of each 8-row step are its rows 2t and 2t + 1 (in both operands,
// so the sum is unchanged), which spreads a warp's fragment loads over all
// 32 banks through the 128-byte swizzle.
//
// Launches 1 and 2 read g, x and d1 and write t, d1 and dx straight from and
// to registers at the accumulator's positions, not through TMA: beside
// gamma's planes, shared memory holds a single float32 stage of x and g
// together, too few for two warpgroups taking turns. At C <= 64 a thread
// takes two neighbouring channels (four threads fill a 32-byte sector) and
// the norm's x comes from its tile in shared memory; the fused launch does
// the same from the cluster loop's registers. At C = 192 and 256 each block
// of a cluster computes its slice of the output channels from tiles that
// come once per cluster (csrc/gdn_wide.cuh says why gamma must be cut
// there); one exchange within the quad first gives a thread four
// neighbouring channels (16 bytes of float32). The cluster launches
// prefetch their epilogue's operands in device memory into L2 when a tile
// starts. Rows whose stride TMA cannot describe (C % 4 in float32, C % 8 in
// bfloat16, an unaligned base) are padded by the wrapper: zero gamma
// columns and x, g, unit beta, so the padded channels add nothing to dx,
// dgamma or dbeta.

#include "gdn_wide.cuh"

namespace {

constexpr int THREADS = 256;  // the reduce launch

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

// t and d1 from the norm n (n >= beta > 0), both directions from one
// r = rsqrt(n) (within 2 ulp): GDN t = g*x*r^3, d1 = g*r; IGDN t = g*x*r,
// d1 = g*(n*r) (s = sqrt(n) as n*r). A correctly rounded square root and
// division for IGDN cost the cluster loop's IGDN norm a third more time
// than GDN's (0.56 against 0.43 ms at 262,144 rows of C = 192 on an H100);
// with r the two take the same time.
template <bool INVERSE>
__device__ __forceinline__ void terms(float n, float x, float g, float& t, float& d1) {
  const float r = rsqrtf(n);
  if (INVERSE) {
    t = g * x * r;
    d1 = g * (n * r);
  } else {
    t = g * x * (r * r * r);
    d1 = g * r;
  }
}

// Launch 1's epilogue at C <= 64: x from the shared tile, g from device
// memory; t and d1 (float32) out. Accumulator element 4j + 2h + e: row
// row0 + ra + 8h, channel 8j + 2*t4 + e.
template <typename T, int CP, bool INVERSE>
struct NormEpilogue {
  const T* g;
  float* t;
  float* d1;
  int n_rows, c;

  __device__ __forceinline__ void operator()(uint8_t* tile, const float* acc,
                                             const float* beta_s, int row0, int ra,
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
          const int col = 8 * (j0 + j) + 2 * t4;
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
          const int col = 8 * (j0 + j) + 2 * t4;
          const int row = row0 + ra + 8 * h;
          if (row < n_rows && col < c) {
            const Pair<T> xr = *reinterpret_cast<const Pair<T>*>(
                tile + (col / K::COLS) * BOX_TILE_BYTES + swz(ra + 8 * h, (col % K::COLS) * K::ESZ));
            const float2 xv = widen(xr), gf = widen(gv[j][h]);
            const int v = 4 * (j0 + j) + 2 * h;
            float t0, t1, d0, d1v;
            terms<INVERSE>(acc[v] + beta_s[col], xv.x, gf.x, t0, d0);
            terms<INVERSE>(acc[v + 1] + beta_s[col + 1], xv.y, gf.y, t1, d1v);
            const int64_t off = static_cast<int64_t>(row) * c + col;
            store_pair(t + off, t0, t1);
            store_pair(d1 + off, d0, d1v);
          }
        }
      }
    }
  }
};

// Launch 2's epilogue at C <= 64: u = t . gamma^T in the accumulator; x
// and d1 from device memory; dx = d1 - x*u (GDN) or d1 + x*u (IGDN) out, in
// x's type. For float32 x, d1 is dx itself: each element is read and then
// written by the same thread.
template <typename T, int CP, bool INVERSE>
struct MixEpilogue {
  const T* x;
  const float* d1;
  T* dx;
  int n_rows, c;

  __device__ __forceinline__ void operator()(uint8_t*, const float* acc, const float*,
                                             int row0, int ra, int t4) const {
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
          const int col = 8 * (j0 + j) + 2 * t4;
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
          const int col = 8 * (j0 + j) + 2 * t4;
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

// Launch 1 at CP = 64. x: (n_rows, c) through x_map; t, d1: (n_rows, c)
// float32.
template <typename T, int CP, bool INVERSE>
__global__ void __launch_bounds__(Cfg<T, CP>::THREADS, 1)
gdn_bwd_norm_kernel(const __grid_constant__ CUtensorMap x_map, const T* __restrict__ g,
                    const float* __restrict__ gamma, const float* __restrict__ beta,
                    float* __restrict__ t, float* __restrict__ d1, int n_rows, int c) {
  mix_rows<T, CP, false, false>(&x_map, nullptr, gamma, beta, n_rows, c,
                                NormEpilogue<T, CP, INVERSE>{g, t, d1, n_rows, c});
}

// Launch 2 at CP = 64. t: (n_rows, c) float32 through t_map; x, dx:
// (n_rows, c) in x's type; d1 float32 (dx itself for float32 x, so neither
// is __restrict__).
template <typename T, int CP, bool INVERSE>
__global__ void __launch_bounds__(Cfg<float, CP>::THREADS, 1)
gdn_bwd_mix_kernel(const __grid_constant__ CUtensorMap t_map, const T* __restrict__ x,
                   const float* __restrict__ gamma, const float* d1, T* dx, int n_rows, int c) {
  mix_rows<float, CP, true, false>(&t_map, nullptr, gamma, nullptr, n_rows, c,
                                   MixEpilogue<T, CP, INVERSE>{x, d1, dx, n_rows, c});
}

// --- launches 1 and 2 at CP = 192 and 256: epilogues of csrc/gdn_wide.cuh's loop

// Four neighbouring channels of a row in device memory: a float4 (float32)
// or two bf16 pairs (bfloat16), as float32, and back.
template <typename T>
using Quad = typename std::conditional<std::is_same<T, float>::value, float4, uint2>::type;
__device__ __forceinline__ float4 widen(float4 v) { return v; }
__device__ __forceinline__ float4 widen(uint2 v) {
  return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
}
__device__ __forceinline__ void store_quad(float* p, const float* a) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ void store_quad(__nv_bfloat16* p, const float* a) {
  *reinterpret_cast<uint2*>(p) = make_uint2(bf16x2_bits(__floats2bfloat162_rn(a[0], a[1])),
                                            bf16x2_bits(__floats2bfloat162_rn(a[2], a[3])));
}

// The 4 values of 16-channel piece jp of row ra + 8h in the accumulator's
// layout (element 4j + 2h + e, j = 2 jp + {0, 1}), as float32 in
// quad_swap's order: from float32 registers (the accumulator, x of float32
// rows) or bf16 pairs (x of bfloat16 rows, pair 2j + h).
__device__ __forceinline__ void piece(const float* v, int jp, int h, float* a) {
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    a[2 * jj] = v[4 * (2 * jp + jj) + 2 * h];
    a[2 * jj + 1] = v[4 * (2 * jp + jj) + 2 * h + 1];
  }
}
__device__ __forceinline__ void piece(const uint32_t* v, int jp, int h, float* a) {
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const uint32_t w = v[2 * (2 * jp + jj) + h];
    a[2 * jj] = __uint_as_float(w << 16);
    a[2 * jj + 1] = __uint_as_float(w & 0xffff0000u);
  }
}

// Asks for the line holding p to be brought into L2.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" :: "l"(p));
}

// The epilogues' operands in device memory, at the lane's four channels of
// each piece of the tile's rows: into L2 when the tile starts, so that the
// epilogue's loads wait on L2 and not on device memory.
template <int NB, int N0, typename T>
__device__ __forceinline__ void prefetch_pieces(const T* a, long long row, int t4, int n_rows,
                                                int c) {
  const int sub = quad_channel(t4);
#pragma unroll
  for (int jp = 0; jp < NB / 16; ++jp) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = row + 8 * h;
      const int col = N0 + 16 * jp + sub;
      if (r < n_rows && col < c) prefetch_l2(a + r * c + col);
    }
  }
}

// Pieces of 16 channels (of a row pair) whose loads are in flight together
// in the cluster loop's epilogues: few enough that their operands fit in
// registers beside the accumulator (and the norm's x).
__host__ __device__ constexpr int wide_piece_group(int pieces) {
  return pieces % 4 == 0 ? 4 : 3;
}

// Launch 1's epilogue on the cluster loop, the block's channels N0 + [0,
// NB): n = acc + beta and x (from the loop's registers) exchanged by
// quad_swap, then g from device memory at the lane's four channels (a
// group of pieces' loads issued before any is used), t and d1 (float32)
// out in 16-byte pieces.
template <typename T, bool INVERSE>
struct WideNormOut {
  const T* g;
  float* t;
  float* d1;
  int c;

  template <int NB, int N0>
  __device__ __forceinline__ void prefetch(long long row, int t4, int n_rows) const {
    prefetch_pieces<NB, N0>(g, row, t4, n_rows, c);
  }

  template <int NB, int N0, typename XReg>
  __device__ __forceinline__ void put(const float* acc, const XReg* xs, const float* beta_s,
                                      long long row, int t4, int n_rows) const {
    constexpr int JP = NB / 16;
    constexpr int JG = wide_piece_group(JP);
    static_assert(JP % JG == 0, "whole groups of pieces");
    const bool odd = t4 & 1;
    const int sub = quad_channel(t4);
#pragma unroll
    for (int j0 = 0; j0 < JP; j0 += JG) {
      Quad<T> gq[JG][2];
#pragma unroll
      for (int j = 0; j < JG; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long r = row + 8 * h;
          const int col = N0 + 16 * (j0 + j) + sub;
          if (r < n_rows && col < c) gq[j][h] = *reinterpret_cast<const Quad<T>*>(g + r * c + col);
        }
      }
#pragma unroll
      for (int j = 0; j < JG; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float n[4], xv[4];
          piece(acc, j0 + j, h, n);
          piece(xs, j0 + j, h, xv);
          quad_swap(n, odd);
          quad_swap(xv, odd);
          const long long r = row + 8 * h;
          const int col = N0 + 16 * (j0 + j) + sub;
          if (r < n_rows && col < c) {
            const float4 b = *reinterpret_cast<const float4*>(beta_s + 16 * (j0 + j) + sub);
            const float4 gv = widen(gq[j][h]);
            float tv[4], dv[4];
            terms<INVERSE>(n[0] + b.x, xv[0], gv.x, tv[0], dv[0]);
            terms<INVERSE>(n[1] + b.y, xv[1], gv.y, tv[1], dv[1]);
            terms<INVERSE>(n[2] + b.z, xv[2], gv.z, tv[2], dv[2]);
            terms<INVERSE>(n[3] + b.w, xv[3], gv.w, tv[3], dv[3]);
            store_quad(t + r * c + col, tv);
            store_quad(d1 + r * c + col, dv);
          }
        }
      }
    }
  }
};

// Launch 2's epilogue on the cluster loop: u = t . gamma^T in the
// accumulator, exchanged by quad_swap; x and d1 from device memory at the
// lane's four channels (a group of pieces' loads issued before any is
// used); dx = d1 -+ x*u out in x's type, as MixEpilogue computes it.
template <typename T, bool INVERSE>
struct WideMixOut {
  const T* x;
  const float* d1;
  T* dx;
  int c;

  template <int NB, int N0>
  __device__ __forceinline__ void prefetch(long long row, int t4, int n_rows) const {
    prefetch_pieces<NB, N0>(x, row, t4, n_rows, c);
    prefetch_pieces<NB, N0>(d1, row, t4, n_rows, c);
  }

  template <int NB, int N0, typename XReg>
  __device__ __forceinline__ void put(const float* acc, const XReg*, const float*, long long row,
                                      int t4, int n_rows) const {
    constexpr int JP = NB / 16;
    constexpr int JG = wide_piece_group(JP);
    static_assert(JP % JG == 0, "whole groups of pieces");
    const bool odd = t4 & 1;
    const int sub = quad_channel(t4);
#pragma unroll
    for (int j0 = 0; j0 < JP; j0 += JG) {
      Quad<T> xq[JG][2];
      float4 dq[JG][2];
#pragma unroll
      for (int j = 0; j < JG; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long r = row + 8 * h;
          const int col = N0 + 16 * (j0 + j) + sub;
          if (r < n_rows && col < c) {
            xq[j][h] = *reinterpret_cast<const Quad<T>*>(x + r * c + col);
            dq[j][h] = *reinterpret_cast<const float4*>(d1 + r * c + col);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < JG; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float u[4];
          piece(acc, j0 + j, h, u);
          quad_swap(u, odd);
          const long long r = row + 8 * h;
          const int col = N0 + 16 * (j0 + j) + sub;
          if (r < n_rows && col < c) {
            const float4 xf = widen(xq[j][h]);
            const float4 d = dq[j][h];
            const float s = INVERSE ? 1.0f : -1.0f;
            const float o[4] = {d.x + s * xf.x * u[0], d.y + s * xf.y * u[1],
                                d.z + s * xf.z * u[2], d.w + s * xf.w * u[3]};
            store_quad(dx + r * c + col, o);
          }
        }
      }
    }
  }
};

// Launch 1 at CP = 192 and 256 (x_map: x in boxes of Wide<T, CP,
// WIDE_NORM>'s tile rows).
template <typename T, int CP, bool INVERSE>
__global__ void __launch_bounds__(Wide<T, CP, WIDE_NORM>::THREADS, 1)
gdn_bwd_norm_kernel_cluster(const __grid_constant__ CUtensorMap x_map, const T* __restrict__ g,
                            const float* __restrict__ gamma, const float* __restrict__ beta,
                            float* __restrict__ t, float* __restrict__ d1, int n_rows, int c) {
  wide_rows<Wide<T, CP, WIDE_NORM>>(&x_map, gamma, beta, n_rows, c,
                                    WideNormOut<T, INVERSE>{g, t, d1, c});
}

// Launch 2 at CP = 192 and 256 (t_map: boxes of Wide<float, CP, WIDE_MIX>'s
// tile rows).
template <typename T, int CP, bool INVERSE>
__global__ void __launch_bounds__(Wide<float, CP, WIDE_MIX>::THREADS, 1)
gdn_bwd_mix_kernel_cluster(const __grid_constant__ CUtensorMap t_map, const T* __restrict__ x,
                           const float* __restrict__ gamma, const float* d1, T* dx, int n_rows,
                           int c) {
  wide_rows<Wide<float, CP, WIDE_MIX>>(&t_map, gamma, nullptr, n_rows, c,
                                       WideMixOut<T, INVERSE>{x, d1, dx, c});
}

// --- launches 1 and 2 at CP = 128: one fused launch on csrc/gdn_wide.cuh's loop

// gamma's Q planes of the fused launch (wide_gamma's W): row o (output
// channel n0 + o) holds gamma[n0 + o][k], TF32 hi and lo, the k slots of
// each k-step in x's pair order, the order in which the norm's accumulator
// holds t for the mix's A fragments.
struct FusedQ {
  using Elem = float;
  static constexpr int CP = 128, NB = 64, ESZ = 4, COLS = BOX_BYTES / ESZ;
  static constexpr bool MIX = true, PAIR_SLOTS = true;
};

// x at accumulator elements 4j + 2h + {0, 1} from load_step's registers:
// float32 values, or the bf16 pair 2j + h.
__device__ __forceinline__ float2 x_pair(const float* xs, int j, int h) {
  return make_float2(xs[4 * j + 2 * h], xs[4 * j + 2 * h + 1]);
}
__device__ __forceinline__ float2 x_pair(const uint32_t* xs, int j, int h) {
  const uint32_t w = xs[2 * j + h];
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

// The consumer warpgroups of the fused launch in the block of rank RANK,
// which owns channels N0 + [0, 64) both as the norm's outputs and as the
// mix's. For each tile of the cluster (64 rows a consumer):
//   1. n = beta + (x*x) . gamma[:, N0 ..] over the ring's boxes, as the
//      norm launch at C = 192 computes it (wide_products, P planes);
//   2. t (in the accumulator's registers) and d1 from one r = rsqrt(n)
//      (`terms`), g read at the accumulator's positions;
//   3. t to the partner: each thread stores its 32 values, as 8 groups of
//      4 (one k-step's A fragment each), into the partner's exchange buffer
//      at its own thread's slots (st.async, counted on the partner's
//      "xfull"), once the partner has read the previous tile's ("xfree");
//      with the dgamma/dbeta stage also t to device memory;
//   4. u = t . gamma[N0 .., :]^T over all 128 k, k-step by k-step in
//      channel order (the mix launch's order): the block's own 64 from its
//      registers, the partner's from the exchange buffer, each split into
//      TF32 hi and lo, B from the Q planes;
//   5. dx = d1 -+ x*u, rounded once to x's type.
// Rank 1's first k-steps are the partner's, rank 0's its own: both sum in
// the same order as the two launches did, so dx keeps their bits. Rows past
// n_rows and channels past c get x = g = 0 (TMA's zero fill, the loads'
// mask), so their t is 0 and adds nothing to u.
template <typename T, bool INVERSE, int RANK>
__device__ __forceinline__ void fused_consume(const uint8_t* ring, const uint64_t* full,
                                              uint32_t empty0, uint32_t p_hi, uint32_t p_lo,
                                              uint32_t q_hi, uint32_t q_lo, const float* beta_s,
                                              const uint8_t* xch, const uint64_t* xfull,
                                              const uint64_t* xfree, const T* __restrict__ g,
                                              float* __restrict__ t_out, T* __restrict__ dx,
                                              int n_rows, int c, int tile0, int tile_step,
                                              int tiles) {
  using W = Wide<T, 128, WIDE_BACKWARD>;
  constexpr int NB = W::NB;
  constexpr int N0 = RANK * NB;
  constexpr uint32_t PARTNER = 1 - RANK;
  constexpr int MIX_FRAGS = W::FRAGS;  // the mix's fragment sets, as the norm's
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int lane = threadIdx.x % 32;
  const int ra = ((threadIdx.x / 32) % 4) * 16 + lane / 4;  // rows ra and ra + 8
  const int t4 = lane % 4;
  // this thread's slots of the consumer's exchange buffer: group s at + s * 2048
  const uint8_t* mine = xch + wg * W::XCH_WG_BYTES + tid * 16;
  const uint32_t peer = mapa(smem_u32(mine), PARTNER);
  const uint32_t xfull_bar = smem_u32(&xfull[wg]), xfree_bar = smem_u32(&xfree[wg]);
  const uint32_t peer_xfull = mapa(xfull_bar, PARTNER);
  float acc[NB / 2];  // the norm, then t
  float d1[NB / 2];
  float u[NB / 2];
  WideXReg<W> xs[wide_xregs<W>()];
  int stage = 0;
  uint32_t phase = 0;
  int k = 0;  // the consumer's tiles so far: the exchange barriers' phase

  for (int tile = tile0; tile < tiles; tile += tile_step, ++k) {
    const long long row = static_cast<long long>(tile) * W::TILE_ROWS + wg * ROWS + ra;
    prefetch_pieces<NB, N0>(g, row, t4, n_rows, c);
    // this tile's bytes from the partner (it has waited on the last phase)
    if (tid == 0) mbar_expect_tx(xfull_bar, W::XCH_WG_BYTES);
    wide_products<W, N0>(ring, full, empty0, p_hi, p_lo, ra, t4, acc, xs, stage, phase);
    wgmma_wait<0>();
#pragma unroll
    for (int v = 0; v < NB / 2; ++v) fence_operand(acc[v]);

    // 2. t and d1; every load of g issued before any is used
    float2 gv[NB / 8][2];
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long r = row + 8 * h;
        const int col = N0 + 8 * j + 2 * t4;
        gv[j][h] = make_float2(0.0f, 0.0f);
        if (r < n_rows && col < c) {
          gv[j][h] = widen(*reinterpret_cast<const Pair<T>*>(g + r * c + col));
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int v = 4 * j + 2 * h;
        const float2 xv = x_pair(xs, j, h);
        const float2 b = *reinterpret_cast<const float2*>(beta_s + 8 * j + 2 * t4);
        terms<INVERSE>(acc[v] + b.x, xv.x, gv[j][h].x, acc[v], d1[v]);
        terms<INVERSE>(acc[v + 1] + b.y, xv.y, gv[j][h].y, acc[v + 1], d1[v + 1]);
      }
    }

    // 3. t to the partner, then to device memory for the dgamma/dbeta stage
    if (k > 0) mbar_wait_cluster(xfree_bar, (k - 1) & 1);
#pragma unroll
    for (int s = 0; s < NB / 8; ++s) {
      st_async(peer + s * 128 * 16, acc[4 * s], acc[4 * s + 1], acc[4 * s + 2], acc[4 * s + 3],
               peer_xfull);
    }
    if (t_out != nullptr) {
#pragma unroll
      for (int j = 0; j < NB / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long r = row + 8 * h;
          const int col = N0 + 8 * j + 2 * t4;
          if (r < n_rows && col < c) store_pair(t_out + r * c + col, acc[4 * j + 2 * h],
                                                acc[4 * j + 2 * h + 1]);
        }
      }
    }

    // 4. u over the 16 k-steps of 8 channels, a fragment set a k-step
#pragma unroll
    for (int v = 0; v < NB / 2; ++v) {
      u[v] = 0.0f;
      fence_operand(u[v]);
    }
    uint32_t a_hi[MIX_FRAGS][4], a_lo[MIX_FRAGS][4];
#pragma unroll
    for (int ks = 0; ks < 16; ++ks) {
      const bool own = ks / 8 == RANK;
      // the products that read this set are done
      if (ks >= MIX_FRAGS) wgmma_wait<MIX_FRAGS - 1>();
      // fragment register q: row ra + 8 (q & 1), channel 8 ks + 2 t4 + (q >> 1)
      float a[4];
      if (own) {
        const int s = ks % 8;
        a[0] = acc[4 * s];
        a[1] = acc[4 * s + 2];
        a[2] = acc[4 * s + 1];
        a[3] = acc[4 * s + 3];
      } else {
        if (ks % 8 == 0) mbar_wait_cluster(xfull_bar, k & 1);
        const float4 f = *reinterpret_cast<const float4*>(mine + (ks % 8) * 128 * 16);
        a[0] = f.x;
        a[1] = f.z;
        a[2] = f.y;
        a[3] = f.w;
      }
      uint32_t* hi = a_hi[ks % MIX_FRAGS];
      uint32_t* lo = a_lo[ks % MIX_FRAGS];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        hi[q] = tf32_rna(a[q]);
        lo[q] = tf32_rna(a[q] - __uint_as_float(hi[q]));
      }
      wgmma_fence();
      const uint32_t off = (ks / 4) * (NB * BOX_BYTES) + (ks % 4) * 32;
      Mma<NB>::tf32(u, lo, desc_b128(q_hi + off));
      Mma<NB>::tf32(u, hi, desc_b128(q_lo + off));
      Mma<NB>::tf32(u, hi, desc_b128(q_hi + off));
      wgmma_commit();
      if (!own && ks % 8 == 7) {
        // every value of the partner's t is in a fragment: its buffer is free
        __syncwarp();
        if (lane == 0) mbar_arrive_remote(xfree_bar, PARTNER);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int v = 0; v < NB / 2; ++v) fence_operand(u[v]);

    // 5. dx, as the mix launch's epilogue computes it
#pragma unroll
    for (int j = 0; j < NB / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long r = row + 8 * h;
        const int col = N0 + 8 * j + 2 * t4;
        if (r < n_rows && col < c) {
          const int v = 4 * j + 2 * h;
          const float2 xv = x_pair(xs, j, h);
          const float s = INVERSE ? 1.0f : -1.0f;
          store_pair(dx + r * c + col, d1[v] + s * xv.x * u[v], d1[v + 1] + s * xv.y * u[v + 1]);
        }
      }
    }
  }
  // the partner's last arrival on "xfree" has landed: nothing reaches this
  // block once it exits
  if (k > 0) mbar_wait_cluster(xfree_bar, (k - 1) & 1);
}

// Launches 1 and 2 fused at CP = 128 (C from 65 to 128): x through x_map
// (boxes of Wide<T, 128, WIDE_BACKWARD>'s 128 tile rows), g and dx (n_rows,
// c) in x's type; t (n_rows, c) float32 written only where it is not null
// (the dgamma/dbeta stage reads it). The shared-memory layout of
// Wide<T, 128, WIDE_BACKWARD>: P planes (hi, lo), Q planes (hi, lo), the
// ring, the exchange buffers (a consumer's 16 KB), beta, the ring's and the
// exchange's mbarriers.
template <typename T, bool INVERSE>
__global__ void __launch_bounds__(Wide<T, 128, WIDE_BACKWARD>::THREADS, 1)
gdn_bwd_fused_kernel(const __grid_constant__ CUtensorMap x_map, const T* __restrict__ g,
                     const float* __restrict__ gamma, const float* __restrict__ beta,
                     float* __restrict__ t, T* __restrict__ dx, int n_rows, int c) {
  using W = Wide<T, 128, WIDE_BACKWARD>;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle is keyed to address bits 7-9: align the boxes to 1024 bytes
  // (the same offset in every block of the cluster, as multicast needs)
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* p_hi = smem;
  uint8_t* p_lo = p_hi + W::PLANE_BYTES;
  uint8_t* q_hi = p_lo + W::PLANE_BYTES;
  uint8_t* q_lo = q_hi + W::Q_PLANE_BYTES;
  uint8_t* ring = q_lo + W::Q_PLANE_BYTES;
  uint8_t* xch = ring + W::STAGES * W::BOX;
  float* beta_s = reinterpret_cast<float*>(xch + W::XCH_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(beta_s + W::NB);
  uint64_t* empty = full + W::STAGES;  // used in rank 0 alone
  uint64_t* xfull = empty + W::STAGES;
  uint64_t* xfree = xfull + W::CONSUMERS;

  const int rank = static_cast<int>(cluster_ctarank());
  const int n0 = rank * W::NB;
  const int tile0 = static_cast<int>(cluster_id_x());
  const int tile_step = static_cast<int>(cluster_count_x());
  const int tiles = (n_rows - 1) / W::TILE_ROWS + 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < W::STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), W::RELEASES);
    }
    for (int w = 0; w < W::CONSUMERS; ++w) {
      mbar_init(smem_u32(&xfull[w]), 1);  // the owner's expect_tx, then the partner's bytes
      mbar_init(smem_u32(&xfree[w]), 4);  // the partner consumer's warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every block's barriers exist before any box, store or remote arrival reaches them
  cluster_sync();

  if (threadIdx.x >= 128 * W::CONSUMERS) {
    setmaxnreg_dec<W::PRODUCER_REGS>();
    if (threadIdx.x == 128 * W::CONSUMERS) {
      wide_produce<W>(&x_map, ring, full, empty, rank, tile0, tile_step, tiles);
    }
  } else {
    setmaxnreg_inc<W::CONSUMER_REGS>();
    // both layouts of gamma while the first boxes are in flight
    wide_gamma<W, 128 * W::CONSUMERS>(threadIdx.x, p_hi, p_lo, beta_s, gamma, beta, n0, c);
    wide_gamma<FusedQ, 128 * W::CONSUMERS>(threadIdx.x, q_hi, q_lo, nullptr, gamma, nullptr, n0,
                                           c);
    fence_async_smem();
    named_bar_sync(1, 128 * W::CONSUMERS);
    if (rank == 0) {
      fused_consume<T, INVERSE, 0>(ring, full, smem_u32(&empty[0]), smem_u32(p_hi),
                                   smem_u32(p_lo), smem_u32(q_hi), smem_u32(q_lo), beta_s, xch,
                                   xfull, xfree, g, t, dx, n_rows, c, tile0, tile_step, tiles);
    } else {
      fused_consume<T, INVERSE, 1>(ring, full, smem_u32(&empty[0]), smem_u32(p_hi),
                                   smem_u32(p_lo), smem_u32(q_hi), smem_u32(q_lo), beta_s, xch,
                                   xfull, xfree, g, t, dx, n_rows, c, tile0, tile_step, tiles);
    }
  }
}

// Launch 3's blocks: a block owns a BM x BN tile of dgamma (inputs i0 ..,
// outputs o0 ..) for one chunk of rows, one warpgroup for each 64 inputs
// and wgmma's N = BN outputs; BM and BN cover the padded width CP in
// SLICES_I x SLICES_O tiles (C = 192: all 192 inputs, a third of the
// outputs each). A stage of the ring holds one 32-row tile of x (the
// block's inputs, in x's type) and of t (its outputs, float32) as 128-byte
// swizzled TMA boxes; t's tile, split, also goes to K-major planes (three
// buffers of hi and lo, BN rows of 32 k slots each), wgmma's B.
constexpr int PROWS = 32;  // rows per tile of launch 3: one 128-byte row of K-major B

template <typename T, int CP>
struct PartCfg {
  static constexpr int ESZ = sizeof(T);
  static constexpr int BM = CP == 192 ? 192 : (CP < 128 ? CP : 128);
  static constexpr int BN = CP == 192 ? 64 : (CP < 128 ? CP : 128);
  static constexpr int XCOLS = BOX_BYTES / ESZ;  // x channels per box: 32 or 64
  static constexpr int XBOXES = (BM + XCOLS - 1) / XCOLS;
  static constexpr int TBOXES = BN / 32;         // t: float32, 32 channels a box
  static constexpr int THREADS = 128 * (BM / 64);
  static constexpr int SLICES_I = CP / BM, SLICES_O = CP / BN;
  static constexpr int BOX = PROWS * BOX_BYTES;  // one box of a tile
  static constexpr int X_BYTES = XBOXES * BOX;
  static constexpr int STAGE_BYTES = X_BYTES + TBOXES * BOX;
  static constexpr int PLANE_BYTES = BN * BOX_BYTES;
  static constexpr int PLANES = 6 * PLANE_BYTES;
  static constexpr int FIT = (SMEM_LIMIT - SMEM_RESERVE - PLANES) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int SMEM = 1024 + PLANES + STAGES * STAGE_BYTES + STAGES * 8;
  static_assert(BM % 64 == 0 && BN % 32 == 0 && CP % BM == 0 && CP % BN == 0, "tiles");
  static_assert(THREADS % BN == 0 && THREADS * 4 <= PLANES, "staging threads, dbeta sums");
  static_assert(STAGES >= 2 && SMEM <= SMEM_LIMIT, "shared memory");
};

// x*x of one element of a tile in shared memory, in float32 (exact for
// bfloat16 x).
__device__ __forceinline__ float square_at(float, const uint8_t* p) {
  const float v = *reinterpret_cast<const float*>(p);
  return v * v;
}
__device__ __forceinline__ float square_at(__nv_bfloat16, const uint8_t* p) {
  const float v = __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
  return v * v;
}

// v -> TF32 hi and lo: hi is v rounded to TF32 (to nearest, ties away
// from zero, as cvt.rna, in two integer operations), lo = v - hi exactly,
// whose low 13 bits the tensor cores ignore (lo truncated to TF32).
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// Launch 3. x through x_map (n_rows x c, x's type), t through t_map
// (float32), both in boxes of PROWS rows. Block (blockIdx.x: the dgamma
// tile, blockIdx.y: chunk z of chunk_rows rows, a multiple of PROWS) writes
// part[z][i][o] = sum over the chunk's rows of x[r][i]^2 * t[r][o] for its
// tile, each warpgroup's 64 x BN summed by m64nBNk8 over the chunk's 8-row
// steps in order; where i0 == 0 it also writes the dbeta partials
// part[chunks * c * c + z * c + o] = sum over the chunk's rows of t[r][o].
// Rows past n_rows come in as TMA's zeros and add nothing. The k slots t4
// and t4 + 4 of each step are its rows 2 t4 and 2 t4 + 1, in A's fragments
// and B's planes alike.
template <typename T, int CP>
__global__ void __launch_bounds__(PartCfg<T, CP>::THREADS, 1)
gdn_bwd_partials_kernel(const __grid_constant__ CUtensorMap x_map,
                        const __grid_constant__ CUtensorMap t_map, float* __restrict__ part,
                        int n_rows, int c, int chunk_rows, int chunks) {
  using K = PartCfg<T, CP>;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle is keyed to address bits 7-9: align the tiles to 1024 bytes
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* planes = smem;  // [buffer: tile % 3][hi, lo][BN rows][32 k slots]
  uint8_t* stages = smem + K::PLANES;
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + K::STAGES * K::STAGE_BYTES);

  const int i0 = static_cast<int>(blockIdx.x / K::SLICES_O) * K::BM;
  const int o0 = static_cast<int>(blockIdx.x % K::SLICES_O) * K::BN;
  const int z = blockIdx.y;
  const int r_begin = z * chunk_rows;
  const int r_end = r_begin + chunk_rows < n_rows ? r_begin + chunk_rows : n_rows;
  const int tiles = (r_end - r_begin + PROWS - 1) / PROWS;
  // the chunk's tile i goes to ring stage i % STAGES
  auto load_tile = [&](int i) {
    const int s = i % K::STAGES;
    const uint32_t bar = smem_u32(&full[s]);
    mbar_expect_tx(bar, K::STAGE_BYTES);
    const uint32_t dst = smem_u32(stages + s * K::STAGE_BYTES);
    const int row = r_begin + i * PROWS;
    for (int j = 0; j < K::XBOXES; ++j) {
      tma_load(dst + j * K::BOX, &x_map, bar, i0 + j * K::XCOLS, row);
    }
    for (int j = 0; j < K::TBOXES; ++j) {
      tma_load(dst + K::X_BYTES + j * K::BOX, &t_map, bar, o0 + 32 * j, row);
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < K::STAGES; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < K::STAGES && i < tiles; ++i) load_tile(i);
  }

  // staging: this thread's output column sn and groups of 4 k slots q
  constexpr int QSTEP = K::THREADS / K::BN;
  constexpr int QITEMS = (8 + QSTEP - 1) / QSTEP;
  const int sn = threadIdx.x % K::BN, sq0 = threadIdx.x / K::BN;
  float tsum = 0.0f;  // t summed over this thread's rows of column sn
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int ra = ((threadIdx.x / 32) % 4) * 16 + lane / 4;  // A rows ra and ra + 8
  const int t4 = lane % 4;

  // Tile i's operands from its stage: x^2 of the warpgroup's 64 inputs,
  // split, into registers hi, lo (A: (input ra, slot t4), (ra + 8, t4),
  // (ra, t4 + 4), (ra + 8, t4 + 4) of each k-step), and t, split, into
  // planes buffer i % 3 (B: slots 4q .. 4q + 3 are rows 8 (q / 2) + 2j +
  // (q & 1), j = 0 .. 3).
  auto operands = [&](int i, uint32_t* hi, uint32_t* lo) {
    const uint8_t* xs = stages + (i % K::STAGES) * K::STAGE_BYTES;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int m = 64 * wg + ra + 8 * (q & 1);
        const uint8_t* box = xs + (m / K::XCOLS) * K::BOX;
        split_tf32(square_at(T(), box + swz(8 * ks + 2 * t4 + (q >> 1), (m % K::XCOLS) * K::ESZ)),
                   hi[4 * ks + q], lo[4 * ks + q]);
      }
    }
    const uint8_t* tbox = xs + K::X_BYTES + (sn / 32) * K::BOX;
    uint8_t* plane = planes + (i % 3) * 2 * K::PLANE_BYTES;
#pragma unroll
    for (int k = 0; k < QITEMS; ++k) {
      const int q = sq0 + k * QSTEP;
      if (q < 8) {
        uint32_t h[4], l[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float v = *reinterpret_cast<const float*>(
              tbox + swz(8 * (q >> 1) + 2 * j + (q & 1), 4 * (sn % 32)));
          tsum += v;
          split_tf32(v, h[j], l[j]);
        }
        const uint32_t off = swz(sn, 16 * q);
        *reinterpret_cast<uint4*>(plane + off) = make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(plane + K::PLANE_BYTES + off) =
            make_uint4(l[0], l[1], l[2], l[3]);
      }
    }
    fence_async_smem();  // the planes are read by wgmma
  };

  float acc[K::BN / 2];
#pragma unroll
  for (int v = 0; v < K::BN / 2; ++v) {
    acc[v] = 0.0f;
    fence_operand(acc[v]);
  }
  uint32_t a_hi[2][16], a_lo[2][16];

  // Tile i: its products (A in hi, lo; B in planes buffer i % 3) run while
  // this thread builds tile i + 1's operands into hi_next, lo_next (free
  // once tile i - 1's products are done) and planes buffer (i + 1) % 3
  // (free since the last barrier: tile i - 2's products were done in every
  // warpgroup before it). One barrier a tile: tile i + 1's planes are
  // written, tile i - 1's products done everywhere, tile i + 1's stage read.
  auto step = [&](int i, uint32_t* hi, uint32_t* lo, uint32_t* hi_next, uint32_t* lo_next) {
    wgmma_fence();
    const uint32_t b = smem_u32(planes + (i % 3) * 2 * K::PLANE_BYTES);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint64_t b_hi = desc_b128(b + ks * 32), b_lo = desc_b128(b + K::PLANE_BYTES + ks * 32);
      Mma<K::BN>::tf32(acc, lo + 4 * ks, b_hi);
      Mma<K::BN>::tf32(acc, hi + 4 * ks, b_lo);
      Mma<K::BN>::tf32(acc, hi + 4 * ks, b_hi);
    }
    wgmma_commit();
    wgmma_wait<1>();  // tile i - 1's products
    if (i + 1 < tiles) {
      mbar_wait(smem_u32(&full[(i + 1) % K::STAGES]), ((i + 1) / K::STAGES) & 1);
      operands(i + 1, hi_next, lo_next);
    }
    __syncthreads();
    if (threadIdx.x == 0 && i + 1 + K::STAGES < tiles) load_tile(i + 1 + K::STAGES);
  };

  mbar_wait(smem_u32(&full[0]), 0);  // a chunk has at least one row
  operands(0, a_hi[0], a_lo[0]);
  __syncthreads();
  if (threadIdx.x == 0 && K::STAGES < tiles) load_tile(K::STAGES);
  // registers by the tile's parity, so that each buffer's index is known
  // when compiling
  for (int i = 0; i < tiles; i += 2) {
    step(i, a_hi[0], a_lo[0], a_hi[1], a_lo[1]);
    if (i + 1 < tiles) step(i + 1, a_hi[1], a_lo[1], a_hi[0], a_lo[0]);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int v = 0; v < K::BN / 2; ++v) fence_operand(acc[v]);

  // accumulator element 4j + 2h + e: input 64 wg + ra + 8h, output 8j + 2 t4
  // + e; c is even (the wrapper's widths are multiples of 4), so o < c
  // covers o + 1
  float* pg = part + static_cast<int64_t>(z) * c * c;
#pragma unroll
  for (int j = 0; j < K::BN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ii = i0 + 64 * wg + ra + 8 * h;
      const int o = o0 + 8 * j + 2 * t4;
      if (ii < c && o < c) {
        *reinterpret_cast<float2*>(pg + static_cast<int64_t>(ii) * c + o) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
  // dbeta: the column's QSTEP threads' sums, in order (the planes are free)
  __syncthreads();
  float* sums = reinterpret_cast<float*>(planes);
  sums[threadIdx.x] = tsum;
  __syncthreads();
  if (i0 == 0 && threadIdx.x < K::BN && o0 + static_cast<int>(threadIdx.x) < c) {
    float v = 0.0f;
    for (int k = 0; k < QSTEP; ++k) v += sums[k * K::BN + threadIdx.x];
    part[static_cast<int64_t>(chunks) * c * c + static_cast<int64_t>(z) * c + o0 + threadIdx.x] =
        v;
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

// The launches' arguments: x and t in boxes of the rows launches' tile rows
// (64 at C <= 64, the cluster loop's at 128, 192 and 256) and in PROWS-row
// boxes (the partials launch). At CP = 128 t is null without the
// dgamma/dbeta stage, and there is no d1 and no t_map.
template <typename T>
struct RowsArgs {
  CUtensorMap x_map, t_map, xp_map, tp_map;
  const T* x;
  const T* g;
  const float* gamma;
  const float* beta;
  T* dx;
  float* t;
  float* d1;
  int n, c;
};

// Launches 1 and 2: persistent blocks at CP = 64, the fused cluster launch
// at 128, clusters at 192 and 256.
template <typename T, int CP, bool INVERSE>
cudaError_t launch_rows(const RowsArgs<T>& a, cudaStream_t stream) {
  if constexpr (CP == 128) {
    static int fused_clusters[MAX_DEVICES] = {};
    return launch_clusters<Wide<T, 128, WIDE_BACKWARD>>(gdn_bwd_fused_kernel<T, INVERSE>,
                                                        fused_clusters, a.n, stream, a.x_map,
                                                        a.g, a.gamma, a.beta, a.t, a.dx, a.n,
                                                        a.c);
  } else if constexpr (CP == 64) {
    static int norm_sms[MAX_DEVICES] = {}, mix_sms[MAX_DEVICES] = {};
    const cudaError_t err = launch_persistent<Cfg<T, CP>>(
        gdn_bwd_norm_kernel<T, CP, INVERSE>, norm_sms, a.n, stream, a.x_map, a.g, a.gamma,
        a.beta, a.t, a.d1, a.n, a.c);
    if (err != cudaSuccess) return err;
    return launch_persistent<Cfg<float, CP>>(gdn_bwd_mix_kernel<T, CP, INVERSE>, mix_sms, a.n,
                                             stream, a.t_map, a.x, a.gamma, a.d1, a.dx, a.n,
                                             a.c);
  } else {
    static int norm_clusters[MAX_DEVICES] = {}, mix_clusters[MAX_DEVICES] = {};
    const cudaError_t err = launch_clusters<Wide<T, CP, WIDE_NORM>>(
        gdn_bwd_norm_kernel_cluster<T, CP, INVERSE>, norm_clusters, a.n, stream, a.x_map, a.g,
        a.gamma, a.beta, a.t, a.d1, a.n, a.c);
    if (err != cudaSuccess) return err;
    return launch_clusters<Wide<float, CP, WIDE_MIX>>(
        gdn_bwd_mix_kernel_cluster<T, CP, INVERSE>, mix_clusters, a.n, stream, a.t_map, a.x,
        a.gamma, a.d1, a.dx, a.n, a.c);
  }
}

template <typename T, int CP>
cudaError_t launch_partials(const RowsArgs<T>& a, float* part, int chunk_rows, int chunks,
                            cudaStream_t stream) {
  using K = PartCfg<T, CP>;
  static bool opted_in[MAX_DEVICES] = {};  // the shared-memory opt-in, once per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!opted_in[dev]) {
    if ((err = cudaFuncSetAttribute(gdn_bwd_partials_kernel<T, CP>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM)) !=
        cudaSuccess) {
      return err;
    }
    opted_in[dev] = true;
  }
  gdn_bwd_partials_kernel<T, CP>
      <<<dim3(K::SLICES_I * K::SLICES_O, static_cast<unsigned>(chunks)), K::THREADS, K::SMEM,
         stream>>>(a.xp_map, a.tp_map, part, a.n, a.c, chunk_rows, chunks);
  return cudaGetLastError();
}

// Launches 1-2 and, with dgamma, 3-4 at padded width CP.
template <typename T, int CP>
cudaError_t launch_width(const RowsArgs<T>& a, float* dgamma, float* dbeta, float* part,
                         int chunk_rows, int chunks, int inverse, cudaStream_t stream) {
  cudaError_t err =
      inverse ? launch_rows<T, CP, true>(a, stream) : launch_rows<T, CP, false>(a, stream);
  if (err != cudaSuccess || dgamma == nullptr) return err;
  if ((err = launch_partials<T, CP>(a, part, chunk_rows, chunks, stream)) != cudaSuccess) {
    return err;
  }
  const int64_t outs = static_cast<int64_t>(a.c) * a.c + a.c;
  gdn_bwd_reduce_kernel<<<static_cast<unsigned>((outs + THREADS - 1) / THREADS), THREADS, 0,
                          stream>>>(part, dgamma, dbeta, a.c, chunks, inverse ? 0.5f : -0.5f);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_all(const RowsArgs<T>& a, float* dgamma, float* dbeta, float* part,
                       int chunk_rows, int chunks, int inverse, cudaStream_t s) {
  switch ((a.c + 63) / 64) {
    case 1: return launch_width<T, 64>(a, dgamma, dbeta, part, chunk_rows, chunks, inverse, s);
    case 2: return launch_width<T, 128>(a, dgamma, dbeta, part, chunk_rows, chunks, inverse, s);
    case 3: return launch_width<T, 192>(a, dgamma, dbeta, part, chunk_rows, chunks, inverse, s);
    default: return launch_width<T, 256>(a, dgamma, dbeta, part, chunk_rows, chunks, inverse, s);
  }
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
  const bool is_bf16 = std::is_same<T, __nv_bfloat16>::value;
  const bool fused = (c + 63) / 64 == 2;  // CP = 128
  // the scratch: t (at CP = 128 only with dgamma), for bfloat16 rows at
  // the other widths d1, then the partials
  a.t = fused && dgamma == nullptr ? nullptr : static_cast<float*>(scratch);
  a.d1 = fused ? nullptr : is_bf16 ? a.t + n * c : static_cast<float*>(dx);
  float* part = scratch == nullptr ? nullptr
                                  : static_cast<float*>(scratch) +
                                        n * c * (fused ? 1 : is_bf16 ? 2 : 1);
  a.n = static_cast<int>(n);
  a.c = c;
  const bool wide = c > 128;
  const int esz = is_bf16 ? 2 : 4;
  const int x_rows = fused  ? wide_tile_rows(esz, c, WIDE_BACKWARD)
                     : wide ? wide_tile_rows(esz, c, WIDE_NORM)
                            : ROWS;
  const int t_rows = wide ? wide_tile_rows(4, c, WIDE_MIX) : ROWS;
  if (!make_map(&a.x_map, const_cast<void*>(x), n, c, is_bf16, x_rows) ||
      (!fused && !make_map(&a.t_map, a.t, n, c, false, t_rows)) ||
      (dgamma != nullptr && (!make_map(&a.xp_map, const_cast<void*>(x), n, c, is_bf16, PROWS) ||
                             !make_map(&a.tp_map, a.t, n, c, false, PROWS)))) {
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
// scratch: 16-byte aligned float32. From 65 to 128 channels (the fused
// launch, which keeps t and d1 in registers): t (n, c) and then the
// partials (chunks * c * c + chunks * c, chunks = ceil(n / chunk_rows))
// with dgamma, and nothing (scratch may be null) without it. At the other
// widths: t (n, c), then for bfloat16 d1 (n, c), then the partials with
// dgamma. dgamma and dbeta null (both) skip the dgamma/dbeta stage,
// launches 3 and 4.
// Launches four kernels (two without dgamma; one fewer from 65 to 128
// channels) on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue without launching when n < 1, n >= 2^31 - 64, c <
// 1, c > 256, the row stride or an alignment does not suit TMA, chunk_rows
// is not a positive multiple of 32 (launch 3's row tiles), chunks is not
// ceil(n / chunk_rows) or exceeds 65,535, scratch is null where it must
// hold t, or the CUDA library gives no tensor-map encoder.
extern "C" int gdn_backward(const void* x, const void* g, const void* gamma, const void* beta,
                            void* dx, void* dgamma, void* dbeta, void* scratch, long long n,
                            int c, int chunk_rows, int chunks, int inverse, int is_bf16,
                            void* stream) {
  const int esz = is_bf16 ? 2 : 4;
  const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (n < 1 || n >= 0x7fffffffLL - ROWS || c < 1 || c > 256 || (c * esz) % 16 != 0 ||
      misaligned(x) || misaligned(g) || misaligned(dx) || misaligned(scratch) ||
      chunk_rows < 1 || chunk_rows % PROWS != 0 || chunks > 65535 ||
      (dgamma == nullptr) != (dbeta == nullptr) ||
      (scratch == nullptr && (dgamma != nullptr || (c + 63) / 64 != 2)) ||
      static_cast<long long>(chunks) != (n + chunk_rows - 1) / chunk_rows) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? run<__nv_bfloat16>(x, g, gamma, beta, dx, dgamma, dbeta, scratch, n, c,
                                      chunk_rows, chunks, inverse, s)
                 : run<float>(x, g, gamma, beta, dx, dgamma, dbeta, scratch, n, c, chunk_rows,
                              chunks, inverse, s);
}
