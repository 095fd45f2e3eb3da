// The tensor-core loop shared by the GDN kernels (csrc/gdn_kernel.cu, the
// forward; csrc/gdn_bwd_kernel.cu, the backward's norm and mix launches,
// whose partials launch also takes the PTX wrappers below):
// an (N, C) x (C, C) channel mix of 64-row tiles with gamma resident in
// shared memory, on Hopper's wgmma with TMA-fed tiles (sm_90a).
//
// Which widths it serves: the forward at C <= 128 (CP 64 and 128) and the
// backward's norm and mix launches at C <= 64. At CP = 192 and 256 all
// three run the loop of csrc/gdn_wide.cuh instead: there gamma of every
// output channel does not fit in one block beside a ring of row tiles, so a
// cluster of blocks holds it in slices and shares each tile's loads. The
// backward at CP = 128 runs one fused launch on that loop as well
// (csrc/gdn_bwd_kernel.cu says why).
//
//   - Persistent blocks, one per SM, each walking 64-row tiles and
//     computing every output channel of them, so the rows are read from
//     device memory once. gamma (hi and lo planes) stays in shared memory
//     for the block's life, in the K-major, 128-byte-swizzled layout wgmma
//     reads as its B operand.
//   - A ring of row tiles (as many as shared memory holds, up to 8) stays in
//     flight through TMA (cp.async.bulk.tensor, 128-byte swizzle), each stage
//     with an mbarrier. The ragged last tile and the channels past C come
//     from TMA's zero fill. No warp is set aside to load: the warpgroup that
//     finishes a tile refills its stage.
//   - Two (float32) or three (bfloat16) warpgroups take turns on the tiles,
//     so one's copies and CUDA-core work overlap another's products. A
//     warpgroup reads its tile from shared memory in wgmma's A-fragment order
//     (conflict-free through the swizzle), splits it (squared first where the
//     product is the norm's) in registers, and issues wgmma with A from
//     registers and B (gamma) from shared memory, one 128-byte column block
//     of K at a time, the next block's fragments built while the previous
//     block's products run.
//   - Each product is split in three, float32 accumulate: 3xTF32 for float32
//     rows (hi and lo of both operands, lo*lo dropped), exact 3xbf16 for the
//     square of bfloat16 rows (csrc/gdn_kernel.cu says why each is exact
//     enough).
//
// Two layouts of gamma (C_in, C_out) as B, row o of the plane holding the
// product's inputs k: P, gamma[k][o], for the norm n = (x*x) . gamma; Q,
// gamma[o][k], for u = t . gamma^T. TF32 wgmma reads shared-memory operands
// only K-major, so a kernel on this loop holds one of the two; the
// backward's two products are two launches here.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int ROWS = 64;                        // rows per tile: one wgmma's M
constexpr int BOX_BYTES = 128;                  // a row of one TMA box: the swizzle span
constexpr int BOX_TILE_BYTES = ROWS * BOX_BYTES;
constexpr int SMEM_LIMIT = 232448;              // dynamic shared memory a block may use
constexpr int SMEM_RESERVE = 2048;              // alignment slack, beta, mbarriers
constexpr int MAX_DEVICES = 64;

// T: the type of the tiles in the ring (the product's A operand before the
// split); CP: C padded to a multiple of 64.
template <typename T, int CP>
struct Cfg {
  static constexpr int ESZ = sizeof(T);
  static constexpr int COLS = BOX_BYTES / ESZ;           // channels per box: 32 or 64
  static constexpr int BOXES = CP / COLS;                // K blocks per tile
  static constexpr int KSTEPS = 4;                       // wgmma k-steps (32 bytes) per box
  static constexpr int NB = CP;                          // output channels per block: all
  // warpgroups taking turns on tiles: three for bf16 (less CUDA-core work
  // per byte to hide behind the copies), two for float32
  static constexpr int CONSUMERS = ESZ == 2 ? 3 : 2;
  static constexpr int THREADS = 128 * CONSUMERS;
  static constexpr int PLANE_BYTES = NB * CP * ESZ;      // one gamma plane
  static constexpr int STAGE_BYTES = BOXES * BOX_TILE_BYTES;
  static constexpr int FIT = (SMEM_LIMIT - SMEM_RESERVE - 2 * PLANE_BYTES) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int SMEM = 1024 + 2 * PLANE_BYTES + STAGES * STAGE_BYTES + NB * 4 +
                              STAGES * 8;
  static_assert(CP == 64 || CP == 128, "CP 64 and 128; csrc/gdn_wide.cuh serves 192 and 256");
  static_assert(STAGES >= CONSUMERS, "a tile in flight for each consumer");
  static_assert(SMEM <= SMEM_LIMIT, "shared memory");
};

// --- PTX wrappers -----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" :: "r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1)
               : "memory");
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
// Orders this thread's shared-memory accesses before later async-proxy
// (TMA, wgmma) accesses.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Pins an accumulator register around the asynchronous products.
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r) :: "memory");
}

// wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row groups
// 1024 bytes apart.
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) |
         (1ull << 62);
}

// Byte offset of (row, byte) in rows of 128 bytes with the 128-byte swizzle
// (the 16-byte chunk index XOR row % 8), from a 1024-byte aligned base.
__device__ __forceinline__ uint32_t swz(int row, int byte) {
  return row * BOX_BYTES + ((((byte >> 4) ^ row) & 7) << 4) + (byte & 15);
}

__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// m64nNk8 (TF32) and m64nNk16 (bf16) with A (four 32-bit registers a
// thread) from registers, B from shared memory, float32 accumulate: N = 64
// and 128 for mix_rows, the partials launch and csrc/gdn_wide.cuh, 96 for
// the latter alone.
template <int N>
struct Mma;

template <> struct Mma<64> {
  static __device__ __forceinline__ void tf32(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
  static __device__ __forceinline__ void bf16(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Mma<96> {
  static __device__ __forceinline__ void tf32(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
  static __device__ __forceinline__ void bf16(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
        "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Mma<128> {
  static __device__ __forceinline__ void tf32(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
  static __device__ __forceinline__ void bf16(float* d, const uint32_t* a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <typename T, int N>
__device__ __forceinline__ void mma(float* d, const uint32_t* a, uint64_t b) {
  if constexpr (std::is_same<T, float>::value) {
    Mma<N>::tf32(d, a, b);
  } else {
    Mma<N>::bf16(d, a, b);
  }
}

// --- the split ----------------------------------------------------------------

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// gamma value -> hi and lo planes at byte offset `off`.
__device__ __forceinline__ void split_store(float, uint8_t* hi, uint8_t* lo, uint32_t off,
                                            float g) {
  const uint32_t h = tf32_rna(g);
  *reinterpret_cast<uint32_t*>(hi + off) = h;
  *reinterpret_cast<uint32_t*>(lo + off) = tf32_rna(g - __uint_as_float(h));
}
__device__ __forceinline__ void split_store(__nv_bfloat16, uint8_t* hi, uint8_t* lo,
                                            uint32_t off, float g) {
  const __nv_bfloat16 h = __float2bfloat16_rn(g);
  *reinterpret_cast<__nv_bfloat16*>(hi + off) = h;
  *reinterpret_cast<__nv_bfloat16*>(lo + off) = __float2bfloat16_rn(g - __bfloat162float(h));
}

// A fragments (hi and lo) of one 128-byte column block of the tile for this
// thread's rows ra and ra + 8: four k-steps, four registers each; a = x^2
// (SQUARE, the norm's product) or the tile's value itself (t, the mix's).
// TF32 k-step of 8 channels: (ra, t), (ra+8, t), (ra, t+4), (ra+8, t+4).
template <bool SQUARE>
__device__ __forceinline__ void load_a(float, const uint8_t* box, int ra, int t4,
                                       uint32_t* hi, uint32_t* lo) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = ra + 8 * (q & 1);
      const int col = 8 * ks + t4 + 4 * (q >> 1);
      const float v = *reinterpret_cast<const float*>(box + swz(row, 4 * col));
      const float s = SQUARE ? v * v : v;
      const uint32_t h = tf32_rna(s);
      hi[4 * ks + q] = h;
      lo[4 * ks + q] = tf32_rna(s - __uint_as_float(h));
    }
  }
}

// bf16 k-step of 16 channels, channel pairs: (ra, 2t), (ra+8, 2t),
// (ra, 2t+8), (ra+8, 2t+8). In bf16x2 arithmetic x*x rounded once is s_hi,
// and fma(x, x, -s_hi) is s - s_hi, which is a bf16 value: s_lo, exactly.
template <bool SQUARE>
__device__ __forceinline__ void load_a(__nv_bfloat16, const uint8_t* box, int ra, int t4,
                                       uint32_t* hi, uint32_t* lo) {
  static_assert(SQUARE, "bf16 tiles are x, squared");
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = ra + 8 * (q & 1);
      const int col = 16 * ks + 2 * t4 + 8 * (q >> 1);
      const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(box + swz(row, 2 * col));
      const __nv_bfloat162 h = __hmul2(x, x);
      hi[4 * ks + q] = bf16x2_bits(h);
      lo[4 * ks + q] = bf16x2_bits(__hfma2(x, x, __hneg2(h)));
    }
  }
}

// --- the loop -------------------------------------------------------------------

// The block's part of acc = A . B over the rows of `in_map` (n_rows x c, a
// ring of 64-row tiles of type T): A is the tile squared (P planes, the norm)
// or as it is (MIX: Q planes, u = t . gamma^T). For each tile, the calling
// warpgroup's `epilogue(tile, acc, beta_s, row0, ra, t4)` then gets the
// tile in shared memory (T, 128-byte swizzled boxes), its accumulator
// (element 4j + 2h + e: row row0 + ra + 8h, channel 8j + 2*t4 + e), beta
// (ones past c; only where `beta` is given), the tile's first row and the
// thread's fragment coordinates. With STORE the epilogue has written its
// result into the tile in place, and the tile's boxes go to `out_map`
// through TMA.
template <typename T, int CP, bool MIX, bool STORE, typename Epilogue>
__device__ __forceinline__ void mix_rows(const CUtensorMap* in_map, const CUtensorMap* out_map,
                                         const float* __restrict__ gamma,
                                         const float* __restrict__ beta, int n_rows, int c,
                                         Epilogue epilogue) {
  using K = Cfg<T, CP>;
  extern __shared__ uint8_t smem_raw[];
  // the swizzle is keyed to address bits 7-9: align the tiles to 1024 bytes
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* g_hi = smem;
  uint8_t* g_lo = smem + K::PLANE_BYTES;
  uint8_t* stages = smem + 2 * K::PLANE_BYTES;
  float* beta_s = reinterpret_cast<float*>(stages + K::STAGES * K::STAGE_BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(beta_s + K::NB);

  const int tile0 = blockIdx.x;
  const int tile_step = gridDim.x;
  const int tiles = (n_rows + ROWS - 1) / ROWS;
  const int my_tiles = tile0 < tiles ? (tiles - tile0 + tile_step - 1) / tile_step : 0;
  // the block's tile i goes to ring stage i % STAGES
  auto load_tile = [&](int i) {
    const int s = i % K::STAGES;
    const uint32_t bar = smem_u32(&full[s]);
    mbar_expect_tx(bar, K::STAGE_BYTES);
    const uint32_t dst = smem_u32(stages + s * K::STAGE_BYTES);
    for (int j = 0; j < K::BOXES; ++j) {
      tma_load(dst + j * BOX_TILE_BYTES, in_map, bar, j * K::COLS, (tile0 + i * tile_step) * ROWS);
    }
  };

  // gamma as wgmma's B, zero padded: row o (output channel o) holds input
  // channels k, one 128-byte swizzled row per box of K. P reads
  // gamma[k][o], Q gamma[o][k], each k-fastest where that is the
  // contiguous walk of gamma.
  for (int idx = threadIdx.x; idx < K::NB * CP; idx += K::THREADS) {
    const int o = MIX ? idx / CP : idx % K::NB;
    const int k = MIX ? idx % CP : idx / K::NB;
    float g = 0.0f;
    if (k < c && o < c) {
      g = MIX ? gamma[static_cast<int64_t>(o) * c + k] : gamma[static_cast<int64_t>(k) * c + o];
    }
    const uint32_t off = (k / K::COLS) * (K::NB * BOX_BYTES) + swz(o, (k % K::COLS) * K::ESZ);
    split_store(T(), g_hi, g_lo, off, g);
  }
  if (beta != nullptr) {
    for (int i = threadIdx.x; i < K::NB; i += K::THREADS) {
      beta_s[i] = i < c ? beta[i] : 1.0f;
    }
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < K::STAGES; ++s) mbar_init(smem_u32(&full[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_async_smem();  // gamma is read by wgmma
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < K::STAGES && i < my_tiles; ++i) load_tile(i);
  }

  // warpgroup wg takes the block's tiles wg, wg + CONSUMERS, ...; whoever finishes
  // a tile refills its stage with the tile STAGES later
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int ra = ((threadIdx.x / 32) % 4) * 16 + lane / 4;  // rows ra and ra + 8
  const int t4 = lane % 4;
  const uint32_t hi_base = smem_u32(g_hi), lo_base = smem_u32(g_lo);
  float acc[K::NB / 2];
  uint32_t a_hi[2][16], a_lo[2][16];

  for (int i = wg; i < my_tiles; i += K::CONSUMERS) {
    const int s = i % K::STAGES;
    uint8_t* tile = stages + s * K::STAGE_BYTES;
    mbar_wait(smem_u32(&full[s]), (i / K::STAGES) & 1);

#pragma unroll
    for (int v = 0; v < K::NB / 2; ++v) {
      acc[v] = 0.0f;
      fence_operand(acc[v]);
    }
#pragma unroll
    for (int kc = 0; kc < K::BOXES; ++kc) {
      if (kc >= 2) wgmma_wait<1>();  // the products that read this buffer are done
      uint32_t* hi = a_hi[kc & 1];
      uint32_t* lo = a_lo[kc & 1];
      load_a<!MIX>(T(), tile + kc * BOX_TILE_BYTES, ra, t4, hi, lo);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < K::KSTEPS; ++ks) {
        const uint32_t off = kc * (K::NB * BOX_BYTES) + ks * 32;
        const uint64_t b_hi = desc_b128(hi_base + off), b_lo = desc_b128(lo_base + off);
        mma<T, K::NB>(acc, lo + 4 * ks, b_hi);
        mma<T, K::NB>(acc, hi + 4 * ks, b_lo);
        mma<T, K::NB>(acc, hi + 4 * ks, b_hi);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int v = 0; v < K::NB / 2; ++v) fence_operand(acc[v]);

    const int row0 = (tile0 + i * tile_step) * ROWS;
    epilogue(tile, acc, beta_s, row0, ra, t4);
    fence_async_smem();
    named_bar_sync(1 + wg, 128);  // the warpgroup is done with the stage
    if (threadIdx.x % 128 == 0) {
      if (STORE) {
        for (int box = 0; box < K::BOXES; ++box) {
          tma_store(out_map, smem_u32(tile + box * BOX_TILE_BYTES), box * K::COLS, row0);
        }
        bulk_commit();
        bulk_wait_read_all();  // the stage may be loaded again once the store has read it
      }
      if (i + K::STAGES < my_tiles) load_tile(i + K::STAGES);
    }
  }
  if (STORE && threadIdx.x % 128 == 0) bulk_wait_all();
}

// --- host side ------------------------------------------------------------------

// cuTensorMapEncodeTiled, fetched from libcuda through the runtime so that
// the library needs no link against libcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// (n, c) rows, boxes of box_rows rows x 128 bytes, 128-byte swizzle, zero fill.
bool make_map(CUtensorMap* map, void* ptr, long long n, int c, bool is_bf16,
              int box_rows = ROWS) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const int esz = is_bf16 ? 2 : 4;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(c), static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(c) * esz};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(BOX_BYTES / esz),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, is_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                2, ptr, dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launches `kernel` (a mix_rows kernel of configuration K) as persistent
// blocks over n rows: one per SM, at most one per tile. `sms_of` is the kernel instance's own per-device
// cache: its shared-memory opt-in and the SM count are taken once per device
// (each call costs host time that a small launch would otherwise wait on).
template <typename K, typename Kernel, typename... Args>
cudaError_t launch_persistent(Kernel kernel, int* sms_of, int n, cudaStream_t stream,
                              Args... args) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (sms_of[dev] == 0) {
    int sms = 0;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    K::SMEM)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess) {
      return err;
    }
    sms_of[dev] = sms;
  }
  const long long tiles = (n + ROWS - 1) / ROWS;
  const long long blocks = sms_of[dev] < tiles ? sms_of[dev] : tiles;
  kernel<<<static_cast<unsigned>(blocks), K::THREADS, K::SMEM, stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace
