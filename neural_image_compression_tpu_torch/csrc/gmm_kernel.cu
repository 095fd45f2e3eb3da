// Discretized Gaussian-mixture log-likelihood for Hopper (sm_90a).
//
//   logp[n, m] = log(max(sum_k w[n,k,m] * (Phi(u) - Phi(l)), 1e-9))
//   u = (y[n,m] + 0.5 - mu[n,k,m]) / sigma[n,k,m],  l = (y[n,m] - 0.5 - mu) / sigma
//   Phi(t) = 0.5 * (1 + erf(t / sqrt(2)))
//
// Replaces the Pallas TPU kernel neural_image_compression_tpu/ops/pallas/
// gmm_kernel.py (`_kernel`, launched by `fused_mixture_log_likelihood`).
// That kernel had to bring its own clipped rational erf, which drifts by
// O(1) nat for 1e-9 < p < 1e-6. This one uses CUDA's erff and the exact
// operation order of the plain path (neural_image_compression_tpu/entropy/
// gaussian.py): 1/sigma by IEEE division, the argument scaled by 1/sqrt(2),
// 0.5 * (1 + erf), so its rates follow the JAX package's, tails included.
//
// Backward (gmm_logp_backward): the JAX package has no Pallas backward; its
// training autodiffs the jnp path (entropy/gaussian.py mixture_likelihood,
// then jnp.log). With G = g / p where p >= 1e-9 and 0 below the floor (the
// floor's gradient), phi the standard normal density and s = sigma:
//   dw_k = G * (Phi(u_k) - Phi(l_k))
//   dmu_k = -G * w_k * (phi(u_k) - phi(l_k)) / s_k
//   dsigma_k = -G * w_k * (phi(u_k) * u_k - phi(l_k) * l_k) / s_k
//   dy = sum_k G * w_k * (phi(u_k) - phi(l_k)) / s_k
// The first loop over k recomputes p exactly as the forward does (the floor
// test must agree with it), keeping Phi and the edges in registers.
//
// What bounds both: device memory. A row of the forward reads y, w, mu and
// sigma once and writes logp once, (3K + 2) * M * 4 bytes; the backward
// reads y, g, w, mu, sigma and writes dy, dw, dmu, dsigma, (6K + 3) * M * 4.
// Against that, about 40 (forward) and 70 (backward) float32 operations a
// (position, component): under the card's balance point, but not by much
// (the erf chains take about half the time of the bytes), so the loads must
// stay in flight while the CUDA cores work. The design:
//
//   - A persistent walk of row tiles: tiles of `rows` consecutive rows (a
//     multiple of 4, so that every stream's chunk of a tile, rows * M or
//     rows * K * M floats, is a multiple of 16 bytes whatever M is), about
//     512 positions each, or 1,024 where a block takes 16 or more such
//     (the serve's 73,728 rows); a grid of min(tiles, SMs x
//     blocks an SM); block b takes tiles b, b + grid, ...
//   - A ring of `stages` tiles in shared memory, fed by TMA bulk copies
//     (cp.async.bulk, one a stream: 4 in the forward, 5 in the backward) on
//     a "full" mbarrier a stage, which the copies' bytes complete. A
//     producer warp (one lane) keeps the ring full; the consumer warps
//     release a stage on its "empty" mbarrier once they have written their
//     outputs into it, in place over its inputs; the producer
//     then writes them back with bulk stores (cp.async.bulk.global.shared)
//     and, once those have read the stage, refills it with the tile
//     `stages` later in the walk. The ring takes as many stages as shared
//     memory holds (up to 8): at the flagship's M = 128, K = 3, two blocks
//     an SM, five stages of 20 KB (forward) or 22 KB (backward), or two of
//     40 / 45 KB at the larger tiles, so an SM has 160-225 KB in flight.
//   - Few tiles a block (the train step's 4,096 rows, say): the
//     ring shrinks to a block's tiles and the grid grows to as many blocks
//     as an SM then holds. Where that leaves one tile a block (refinement's
//     1,536 rows), the consumers read it straight from device memory: a
//     thread then computes as soon as its own loads land, where the ring
//     would wait for the whole tile's copies.
//   - Consumers read the stage from shared memory. A consumer thread's
//     (row, column) in the tile comes from its index once per launch and
//     is then stepped by the warps' stride, so no element divides by M;
//     neighbouring threads take neighbouring columns (no bank conflicts).
//   - K is a template parameter (1 to 8, one switch in each entry point),
//     so the component loops are unrolled: a thread issues all 3K + 1 of an
//     element's shared loads before its first erf.
//   - Two load routes in one kernel: the last tile (N mod rows rows), every
//     tile of a call whose pointers are not all 16-byte aligned or whose
//     two stages would not fit in shared memory, and one tile a block, are
//     read by the consumers straight from device memory and written from
//     registers, with the same arithmetic.
//   - On an H100 each choice above measured faster than its alternative at
//     the main path's shapes (PERF.md §6: outputs stored from registers,
//     the ring at one tile a block, 512-position tiles at the serve's
//     rows); tools/gmm_variants.py times variants of this source
//     (tools/gmm_variants.json undoes the last two) and another commit's
//     kernel beside it.
//
// The arithmetic of an element is that of the kernel it replaced: the
// forward's output is bit for bit the same; the backward's formulas and
// their order are unchanged.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr float kInvSqrt2 = 0.70710678118654752440f;
constexpr float kFloor = 1e-9f;
constexpr float kInvSqrt2Pi = 0.39894228040143267794f;
constexpr int MAX_K = 8;
constexpr int MAX_DEVICES = 64;

// --- geometry (ops/kernels/gmm_kernel.py's mixture_geometry mirrors it) -----
constexpr int CONSUMER_WARPS = 8;
constexpr int CONSUMERS = 32 * CONSUMER_WARPS;
constexpr int THREADS = CONSUMERS + 32;          // + the producer warp
constexpr int MAX_STAGES = 8;
constexpr int MIN_STAGES = 2;
constexpr int ROW_STEP = 4;                      // rows of a tile come in fours
constexpr int TILE_POSITIONS = 2 * CONSUMERS;    // (row, column) positions a tile aims at
constexpr int HEADER = 2 * MAX_STAGES * 8;       // the full and empty mbarriers
constexpr int SMEM_SM = 233472;                  // shared memory of an SM
constexpr int SMEM_BLOCK_RESERVE = 1024;         // the system's share of each resident block
constexpr int SMEM_LIMIT = 232448;               // dynamic shared memory one block may use
constexpr int SMEM_HALF = SMEM_SM / 2 - SMEM_BLOCK_RESERVE;  // each of two blocks an SM

struct Geometry {
  int rows;           // rows a tile
  int stages;         // ring stages (0: every tile read straight from device memory)
  int smem;           // dynamic shared memory a block
  int blocks_per_sm;  // blocks the grid places on an SM
};

// Streams of a tile: y (and g) of M floats a row, then w, mu, sigma of K * M.
__host__ __device__ constexpr int streams_of(int k, bool backward) {
  return 3 * k + (backward ? 2 : 1);
}

// Rows: about `positions` positions a tile, fewer where two stages would
// not fit beside a second block; two blocks an SM where two stages fit in
// half an SM's shared memory, else one; stages: as many as fit, at most 8;
// none (the direct route) where fewer than two fit.
__host__ __device__ constexpr Geometry geometry(int k, int m, bool backward,
                                               int positions = TILE_POSITIONS) {
  const long long row_bytes = 4LL * m * streams_of(k, backward);
  int rows = positions / m / ROW_STEP * ROW_STEP;
  if (rows < ROW_STEP) rows = ROW_STEP;
  while (rows > ROW_STEP && HEADER + MIN_STAGES * rows * row_bytes > SMEM_HALF) rows -= ROW_STEP;
  const long long stage = rows * row_bytes;
  const int blocks = HEADER + MIN_STAGES * stage <= SMEM_HALF ? 2 : 1;
  long long stages = ((blocks == 2 ? SMEM_HALF : SMEM_LIMIT) - HEADER) / stage;
  if (stages > MAX_STAGES) stages = MAX_STAGES;
  if (stages < MIN_STAGES) return Geometry{rows, 0, 0, 2};
  return Geometry{rows, static_cast<int>(stages), static_cast<int>(HEADER + stages * stage),
                  blocks};
}

__host__ __device__ constexpr bool same(Geometry a, Geometry b) {
  return a.rows == b.rows && a.stages == b.stages && a.smem == b.smem &&
         a.blocks_per_sm == b.blocks_per_sm;
}

// The flagship's M = 128 at K = 3, K = 1 and 8 at the families' M = 128 and
// 192, narrow and odd widths, and a width whose two stages do not fit.
// tests/test_torch_gmm_geometry.py holds the wrapper's mirror to these.
static_assert(same(geometry(3, 128, false), Geometry{4, 5, 102528, 2}), "geometry");
static_assert(same(geometry(3, 128, true), Geometry{4, 5, 112768, 2}), "geometry");
static_assert(same(geometry(1, 128, false), Geometry{4, 8, 65664, 2}), "geometry");
static_assert(same(geometry(1, 128, true), Geometry{4, 8, 82048, 2}), "geometry");
static_assert(same(geometry(1, 192, false), Geometry{4, 8, 98432, 2}), "geometry");
static_assert(same(geometry(1, 192, true), Geometry{4, 7, 107648, 2}), "geometry");
static_assert(same(geometry(8, 192, false), Geometry{4, 3, 230528, 1}), "geometry");
static_assert(same(geometry(8, 192, true), Geometry{4, 2, 159872, 1}), "geometry");
static_assert(same(geometry(3, 16, false), Geometry{32, 5, 102528, 2}), "geometry");
static_assert(same(geometry(3, 100, true), Geometry{4, 6, 105728, 2}), "geometry");
static_assert(same(geometry(2, 1, false), Geometry{512, 8, 114816, 2}), "geometry");
static_assert(same(geometry(8, 1024, true), Geometry{4, 0, 0, 2}), "geometry");

// --- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}
// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}
// bytes from device memory to shared memory, counted on `bar`
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void bulk_store(float* dst, const float* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(smem_u32(src)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read_all() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Orders this thread's shared-memory writes before later bulk copies.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// --- the element's arithmetic ------------------------------------------------

__device__ __forceinline__ float gaussian_cdf(float t) {
  return 0.5f * (1.0f + erff(t * kInvSqrt2));
}

// A consumer thread's first (row, column) of a tile and its step: the only
// divisions by M, once a launch.
struct Walk {
  int r0, c0, dr, dc;
};

__device__ __forceinline__ Walk walk_of(int m) {
  return Walk{static_cast<int>(threadIdx.x) / m, static_cast<int>(threadIdx.x) % m,
              CONSUMERS / m, CONSUMERS % m};
}

// The next position of the thread: CONSUMERS further on, one carry at most
// (dc < m).
__device__ __forceinline__ void step(int& r, int& c, int m, const Walk& walk) {
  r += walk.dr;
  c += walk.dc;
  if (c >= m) {
    c -= m;
    ++r;
  }
}

// One tile's logp: y (rows, M) and w, mu, sigma (rows, K, M) at these
// addresses (a ring stage or device memory), `positions` = rows * M. `out`
// may be y itself (in the ring): each position is read before it is
// written, by the one thread that owns it.
template <int K>
__device__ __forceinline__ void logp_tile(const float* y, const float* w, const float* mu,
                                          const float* sigma, float* out, int positions, int m,
                                          Walk walk) {
  int r = walk.r0, c = walk.c0;
  for (int p = threadIdx.x; p < positions; p += CONSUMERS) {
    const int e = p + r * (K - 1) * m;  // (r, 0, c) of the (rows, K, M) streams
    const float yv = y[p];
    const float y_hi = yv + 0.5f;
    const float y_lo = yv - 0.5f;
    float mean[K], sig[K], wv[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      mean[j] = mu[e + j * m];
      sig[j] = sigma[e + j * m];
      wv[j] = w[e + j * m];
    }
    float prob = 0.0f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float inv_s = 1.0f / sig[j];
      const float upper = gaussian_cdf(__fmul_rn(__fsub_rn(y_hi, mean[j]), inv_s));
      const float lower = gaussian_cdf(__fmul_rn(__fsub_rn(y_lo, mean[j]), inv_s));
      prob = __fadd_rn(prob, __fmul_rn(wv[j], __fsub_rn(upper, lower)));
    }
    out[p] = logf(fmaxf(prob, kFloor));
    step(r, c, m, walk);
  }
}

// One tile's gradients given g = dL/dlogp. The outputs may be the inputs
// themselves (in the ring: dy over y, dw over w, dmu over mu, dsigma over
// sigma): a position's inputs are all read before its first output.
template <int K>
__device__ __forceinline__ void grad_tile(const float* y, const float* g, const float* w,
                                          const float* mu, const float* sigma, float* dy,
                                          float* dw, float* dmu, float* dsigma, int positions,
                                          int m, Walk walk) {
  int r = walk.r0, c = walk.c0;
  for (int p = threadIdx.x; p < positions; p += CONSUMERS) {
    const int e = p + r * (K - 1) * m;
    const float yv = y[p];
    const float gv = g[p];
    const float y_hi = yv + 0.5f;
    const float y_lo = yv - 0.5f;
    float wv[K], inv_s[K], u[K], l[K], mass[K], mean[K], sig[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      mean[j] = mu[e + j * m];
      sig[j] = sigma[e + j * m];
      wv[j] = w[e + j * m];
    }
    float prob = 0.0f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      inv_s[j] = 1.0f / sig[j];
      u[j] = __fmul_rn(__fsub_rn(y_hi, mean[j]), inv_s[j]);
      l[j] = __fmul_rn(__fsub_rn(y_lo, mean[j]), inv_s[j]);
      mass[j] = __fsub_rn(gaussian_cdf(u[j]), gaussian_cdf(l[j]));
      prob = __fadd_rn(prob, __fmul_rn(wv[j], mass[j]));
    }
    const float gp = prob >= kFloor ? gv / prob : 0.0f;
    float dyv = 0.0f;
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float pu = kInvSqrt2Pi * expf(-0.5f * u[j] * u[j]);
      const float pl = kInvSqrt2Pi * expf(-0.5f * l[j] * l[j]);
      const float a = gp * wv[j] * inv_s[j];
      dw[e + j * m] = gp * mass[j];
      dmu[e + j * m] = -a * (pu - pl);
      dsigma[e + j * m] = -a * (pu * u[j] - pl * l[j]);
      dyv += a * (pu - pl);
    }
    dy[p] = dyv;
    step(r, c, m, walk);
  }
}

// --- the ring ------------------------------------------------------------------

// A tile's streams in device memory: IN inputs, OUT outputs (written from
// the stage's slots OUT_SLOT), the first A of each of M floats a row, the
// others of K * M.
template <int IN, int OUT, int A>
struct Streams {
  const float* in[IN];
  float* out[OUT];
  int out_slot[OUT];
};

// Float offset of slot j in a stage of `rows` rows.
template <int A>
__device__ __forceinline__ int slot_offset(int j, int rows, int m, int km) {
  return j < A ? j * rows * m : A * rows * m + (j - A) * rows * km;
}

// The producer warp's one lane: fills the ring with the block's whole tiles
// in walk order and, once the consumers release a stage, writes its outputs
// back and refills it with the tile `stages` later.
template <int IN, int OUT, int A>
__device__ void produce(const Streams<IN, OUT, A>& s, float* ring, uint64_t* full,
                        uint64_t* empty, long long ring_tiles, int rows, int stages, int m,
                        int km) {
  const int stage_floats = slot_offset<A>(IN, rows, m, km);
  const uint32_t stage_bytes = 4u * stage_floats;
  const long long grid = gridDim.x;
  auto load = [&](int st, long long t) {
    float* dst = ring + st * stage_floats;
    mbar_expect_tx(&full[st], stage_bytes);
#pragma unroll
    for (int j = 0; j < IN; ++j) {
      const int per_row = j < A ? m : km;
      bulk_load(dst + slot_offset<A>(j, rows, m, km), s.in[j] + t * rows * per_row,
                4u * rows * per_row, &full[st]);
    }
  };
  long long next = blockIdx.x;
  for (int st = 0; st < stages && next < ring_tiles; ++st, next += grid) load(st, next);
  int st = 0;
  uint32_t phase = 0;
  for (long long t = blockIdx.x; t < ring_tiles; t += grid) {
    mbar_wait(&empty[st], phase);
    const float* src = ring + st * stage_floats;
#pragma unroll
    for (int j = 0; j < OUT; ++j) {
      const int per_row = s.out_slot[j] < A ? m : km;
      bulk_store(s.out[j] + t * rows * per_row, src + slot_offset<A>(s.out_slot[j], rows, m, km),
                 4u * rows * per_row);
    }
    bulk_commit();
    if (next < ring_tiles) {
      bulk_wait_read_all();  // the stores have read the stage
      load(st, next);
      next += grid;
    }
    if (++st == stages) {
      st = 0;
      phase ^= 1;
    }
  }
  bulk_wait_all();
}

// Sets up the block's barriers; returns the ring.
__device__ __forceinline__ float* ring_setup(unsigned char* smem, uint64_t*& full,
                                             uint64_t*& empty, int stages) {
  full = reinterpret_cast<uint64_t*>(smem);
  empty = full + MAX_STAGES;
  if (threadIdx.x == 0) {
    for (int st = 0; st < stages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return reinterpret_cast<float*>(smem + HEADER);
}

// A consumer warp has written its outputs into stage `st`: the bulk stores
// may read them, then the next copies land in it.
__device__ __forceinline__ void release(uint64_t* empty, int& st, uint32_t& phase, int stages) {
  fence_async_smem();
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(&empty[st]);
  if (++st == stages) {
    st = 0;
    phase ^= 1;
  }
}

template <int K>
__global__ void __launch_bounds__(THREADS, 2)
gmm_logp_kernel(const float* __restrict__ y, const float* __restrict__ w,
                const float* __restrict__ mu, const float* __restrict__ sigma,
                float* __restrict__ logp, long long n, int m, int rows, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t *full, *empty;
  float* ring = ring_setup(smem, full, empty, stages);
  const int km = K * m;
  const long long tiles = (n + rows - 1) / rows;
  const long long ring_tiles = stages ? n / rows : 0;  // whole tiles go through the ring
  if (threadIdx.x >= CONSUMERS) {
    if (threadIdx.x == CONSUMERS && blockIdx.x < ring_tiles) {
      produce<4, 1, 1>(Streams<4, 1, 1>{{y, w, mu, sigma}, {logp}, {0}}, ring, full, empty,
                       ring_tiles, rows, stages, m, km);
    }
    return;
  }
  const Walk walk = walk_of(m);
  const int rm = rows * m, rkm = rows * km;
  int st = 0;
  uint32_t phase = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row0 = t * rows;
    if (t < ring_tiles) {
      float* s = ring + st * (rm + 3 * rkm);
      mbar_wait(&full[st], phase);
      logp_tile<K>(s, s + rm, s + rm + rkm, s + rm + 2 * rkm, s, rm, m, walk);
      release(empty, st, phase, stages);
    } else {
      const int rows_here = static_cast<int>(n - row0 < rows ? n - row0 : rows);
      logp_tile<K>(y + row0 * m, w + row0 * km, mu + row0 * km, sigma + row0 * km,
                   logp + row0 * m, rows_here * m, m, walk);
    }
  }
}

template <int K>
__global__ void __launch_bounds__(THREADS, 2)
gmm_logp_backward_kernel(const float* __restrict__ y, const float* __restrict__ w,
                         const float* __restrict__ mu, const float* __restrict__ sigma,
                         const float* __restrict__ g, float* __restrict__ dy,
                         float* __restrict__ dw, float* __restrict__ dmu,
                         float* __restrict__ dsigma, long long n, int m, int rows, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t *full, *empty;
  float* ring = ring_setup(smem, full, empty, stages);
  const int km = K * m;
  const long long tiles = (n + rows - 1) / rows;
  const long long ring_tiles = stages ? n / rows : 0;
  if (threadIdx.x >= CONSUMERS) {
    if (threadIdx.x == CONSUMERS && blockIdx.x < ring_tiles) {
      // slots: y, g, w, mu, sigma; dy over y, dw over w, dmu over mu, dsigma over sigma
      produce<5, 4, 2>(Streams<5, 4, 2>{{y, g, w, mu, sigma}, {dy, dw, dmu, dsigma},
                                        {0, 2, 3, 4}},
                       ring, full, empty, ring_tiles, rows, stages, m, km);
    }
    return;
  }
  const Walk walk = walk_of(m);
  const int rm = rows * m, rkm = rows * km;
  int st = 0;
  uint32_t phase = 0;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row0 = t * rows;
    if (t < ring_tiles) {
      float* s = ring + st * (2 * rm + 3 * rkm);
      float* sw = s + 2 * rm;
      float* smu = sw + rkm;
      float* ssig = smu + rkm;
      mbar_wait(&full[st], phase);
      grad_tile<K>(s, s + rm, sw, smu, ssig, s, sw, smu, ssig, rm, m, walk);
      release(empty, st, phase, stages);
    } else {
      const int rows_here = static_cast<int>(n - row0 < rows ? n - row0 : rows);
      grad_tile<K>(y + row0 * m, g + row0 * m, w + row0 * km, mu + row0 * km,
                   sigma + row0 * km, dy + row0 * m, dw + row0 * km, dmu + row0 * km,
                   dsigma + row0 * km, rows_here * m, m, walk);
    }
  }
}

// --- host side ------------------------------------------------------------------

bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs) {
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  }
  return true;
}

// The geometry of a call: the ring's where every pointer is 16-byte aligned
// (bulk copies need it), else the direct route. cudaErrorInvalidValue where
// n, k or m is out of range or a tile's positions exceed an int.
cudaError_t call_geometry(long long n, int k, int m, bool backward, bool aligned, Geometry* geo,
                          Geometry* big) {
  if (n < 1 || k < 1 || k > MAX_K || m < 1) return cudaErrorInvalidValue;
  *geo = geometry(k, m, backward);
  *big = geometry(k, m, backward, 2 * TILE_POSITIONS);
  if (static_cast<long long>(big->rows) * k * m > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (!aligned) *geo = *big = Geometry{geo->rows, 0, 0, geo->blocks_per_sm};
  return cudaSuccess;
}

// What a kernel instance keeps per device: its SM count (its shared-memory
// opt-in is made with it), and the blocks an SM holds at the last ring size
// asked for. Each query costs host time that a small launch would wait on.
struct Cached {
  int sms, smem, resident;
};

// Launches `kernel` persistently: min(tiles, SMs x blocks an SM) blocks.
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, Cached* cache, const Geometry& geo, const Geometry& big,
                   long long n, cudaStream_t stream, Args... args) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  Cached& c = cache[dev];
  if (c.sms == 0) {
    int sms = 0;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    SMEM_LIMIT)) != cudaSuccess ||
        (err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                    cudaSharedmemCarveoutMaxShared)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess) {
      return err;
    }
    c.sms = sms;
  }
  // Tiles of 1,024 positions where a block takes 16 or more; few tiles a
  // block: the ring shrinks to a block's tiles and the grid grows to as
  // many blocks as an SM then holds; one tile a block: no ring.
  Geometry g = geo;
  if (big.stages && n / big.rows >= 16LL * c.sms * big.blocks_per_sm) {
    g = big;
  }
  const long long tiles = (n + g.rows - 1) / g.rows;
  long long grid = tiles < static_cast<long long>(c.sms) * g.blocks_per_sm
                       ? tiles : static_cast<long long>(c.sms) * g.blocks_per_sm;
  long long per_block = (tiles + grid - 1) / grid;
  if (per_block < g.stages) {
    const int stage = (g.smem - HEADER) / g.stages;
    const int smem = HEADER + static_cast<int>(per_block) * stage;
    if (c.smem != smem) {
      if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.resident, kernel, THREADS,
                                                               smem)) != cudaSuccess) {
        return err;
      }
      c.smem = smem;
    }
    if (c.resident > g.blocks_per_sm) g.blocks_per_sm = c.resident;
    const long long most = static_cast<long long>(c.sms) * g.blocks_per_sm;
    grid = tiles < most ? tiles : most;
    per_block = (tiles + grid - 1) / grid;
    g = per_block == 1 ? Geometry{g.rows, 0, 0, g.blocks_per_sm}
                       : Geometry{g.rows, static_cast<int>(per_block),
                                  HEADER + static_cast<int>(per_block) * stage, g.blocks_per_sm};
  }
  kernel<<<static_cast<unsigned>(grid), THREADS, g.smem, stream>>>(args..., g.rows, g.stages);
  return cudaGetLastError();
}

template <int K>
cudaError_t forward_k(const float* y, const float* w, const float* mu, const float* sigma,
                      float* logp, long long n, int m, const Geometry& geo, const Geometry& big,
                      cudaStream_t s) {
  static Cached cache[MAX_DEVICES] = {};
  return launch(gmm_logp_kernel<K>, cache, geo, big, n, s, y, w, mu, sigma, logp, n, m);
}

template <int K>
cudaError_t backward_k(const float* y, const float* w, const float* mu, const float* sigma,
                       const float* g, float* dy, float* dw, float* dmu, float* dsigma,
                       long long n, int m, const Geometry& geo, const Geometry& big,
                       cudaStream_t s) {
  static Cached cache[MAX_DEVICES] = {};
  return launch(gmm_logp_backward_kernel<K>, cache, geo, big, n, s, y, w, mu, sigma, g, dy, dw,
                dmu, dsigma, n, m);
}

}  // namespace

// y, logp: (n, m); w, mu, sigma: (n, k, m); all float32 and contiguous.
// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue without launching when n, k or m is below 1 or k
// exceeds 8.
extern "C" int gmm_logp_forward(const void* y, const void* w, const void* mu,
                                const void* sigma, void* logp, long long n,
                                int k, int m, void* stream) {
  Geometry geo{}, big{};
  cudaError_t err = call_geometry(n, k, m, false, aligned16({y, w, mu, sigma, logp}), &geo, &big);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* yf = static_cast<const float*>(y);
  const auto* wf = static_cast<const float*>(w);
  const auto* muf = static_cast<const float*>(mu);
  const auto* sf = static_cast<const float*>(sigma);
  auto* out = static_cast<float*>(logp);
  auto s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: err = forward_k<1>(yf, wf, muf, sf, out, n, m, geo, big, s); break;
    case 2: err = forward_k<2>(yf, wf, muf, sf, out, n, m, geo, big, s); break;
    case 3: err = forward_k<3>(yf, wf, muf, sf, out, n, m, geo, big, s); break;
    case 4: err = forward_k<4>(yf, wf, muf, sf, out, n, m, geo, big, s); break;
    case 5: err = forward_k<5>(yf, wf, muf, sf, out, n, m, geo, big, s); break;
    case 6: err = forward_k<6>(yf, wf, muf, sf, out, n, m, geo, big, s); break;
    case 7: err = forward_k<7>(yf, wf, muf, sf, out, n, m, geo, big, s); break;
    default: err = forward_k<8>(yf, wf, muf, sf, out, n, m, geo, big, s); break;
  }
  return static_cast<int>(err);
}

// y, g (= dL/dlogp), dy: (n, m); w, mu, sigma, dw, dmu, dsigma: (n, k, m);
// all float32 and contiguous. Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue without
// launching when n, k or m is below 1 or k exceeds 8.
extern "C" int gmm_logp_backward(const void* y, const void* w, const void* mu,
                                 const void* sigma, const void* g, void* dy, void* dw,
                                 void* dmu, void* dsigma, long long n, int k, int m,
                                 void* stream) {
  Geometry geo{}, big{};
  cudaError_t err = call_geometry(
      n, k, m, true, aligned16({y, w, mu, sigma, g, dy, dw, dmu, dsigma}), &geo, &big);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* yf = static_cast<const float*>(y);
  const auto* wf = static_cast<const float*>(w);
  const auto* muf = static_cast<const float*>(mu);
  const auto* sf = static_cast<const float*>(sigma);
  const auto* gf = static_cast<const float*>(g);
  auto* o0 = static_cast<float*>(dy);
  auto* o1 = static_cast<float*>(dw);
  auto* o2 = static_cast<float*>(dmu);
  auto* o3 = static_cast<float*>(dsigma);
  auto s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: err = backward_k<1>(yf, wf, muf, sf, gf, o0, o1, o2, o3, n, m, geo, big, s); break;
    case 2: err = backward_k<2>(yf, wf, muf, sf, gf, o0, o1, o2, o3, n, m, geo, big, s); break;
    case 3: err = backward_k<3>(yf, wf, muf, sf, gf, o0, o1, o2, o3, n, m, geo, big, s); break;
    case 4: err = backward_k<4>(yf, wf, muf, sf, gf, o0, o1, o2, o3, n, m, geo, big, s); break;
    case 5: err = backward_k<5>(yf, wf, muf, sf, gf, o0, o1, o2, o3, n, m, geo, big, s); break;
    case 6: err = backward_k<6>(yf, wf, muf, sf, gf, o0, o1, o2, o3, n, m, geo, big, s); break;
    case 7: err = backward_k<7>(yf, wf, muf, sf, gf, o0, o1, o2, o3, n, m, geo, big, s); break;
    default: err = backward_k<8>(yf, wf, muf, sf, gf, o0, o1, o2, o3, n, m, geo, big, s); break;
  }
  return static_cast<int>(err);
}
