// The GDN / IGDN channel mix on a thread-block cluster per group of row
// tiles, on Hopper's wgmma with TMA-fed tiles (sm_90a). Four launches run
// on it (`Wide`'s LAUNCH). At the wide widths, CP = 192 and 256 (C from
// 129 to 256): the forward (csrc/gdn_kernel.cu, out = x * rsqrt(beta +
// (x*x) . gamma)), and the backward's norm and mix (csrc/gdn_bwd_kernel.cu:
// the same product, its epilogue writing t and d1; u = t . gamma^T over
// float32 t, its epilogue writing dx), each with an epilogue of its own. At
// CP = 128 (C from 65 to 128) the backward's fused launch
// (WIDE_BACKWARD, csrc/gdn_bwd_kernel.cu's gdn_bwd_fused_kernel): the
// norm's product over this loop's ring, then t and d1 in registers, t
// exchanged between the cluster's two blocks, and the mix's product from
// registers, so t and d1 never go through device memory. The forward at
// C <= 128, and the backward's launches at C <= 64, run
// csrc/gdn_wgmma.cuh's mix_rows.
//
// Why a loop of its own: gamma's hi and lo planes take 2 * C * C * sizeof
// (float32: 288 KB at C = 192, 512 KB at 256; bfloat16 half that), more
// than one block's 227 KB beside a ring of row tiles, so the output
// channels must be cut into slices that different blocks hold. At these
// widths the 3-way split products also cost about as much as the bytes
// (2 * 3 * N * C^2 operations: 2.11 ms at the TF32 peak against 2.16 ms for
// the bytes at C = 192, N = 4,718,592), so the products must run under the
// copies almost all the time. The design:
//
//   - A cluster of S blocks (`Wide::S`) walks the same row tiles; block
//     rank r holds gamma's planes for output channels [r NB, (r + 1) NB),
//     NB = CP / S, resident for its life (K-major, 128-byte swizzle, as
//     mix_rows holds them): P planes (row o: gamma[:, r NB + o]) for the
//     forward and the norm, Q planes (row o: gamma[r NB + o, :]) for the
//     mix. S is as small as shared memory allows: float32 192 in 2 x 96,
//     256 in 4 x 64; bfloat16 192 in 2 x 96, 256 in 2 x 128 (the mix's
//     tiles are float32 t whatever x's type).
//   - Each x box (t box for the mix: a tile's rows x 128 bytes, one K block
//     of the tile) is fetched from L2 once per cluster: rank 0 issues it with
//     cp.async.bulk.tensor .multicast::cluster into the same ring stage of
//     every block, and it signals each block's own "full" mbarrier. Every
//     block's producer arms its own barrier for each box. A stage is
//     refilled once every consumer warp of every block that reads it has
//     released it: the warps arrive on rank 0's "empty" mbarrier of that
//     stage through the cluster's shared memory window (mapa), 4 x S a
//     phase for each warpgroup that reads the stage.
//   - Loads never wait on an epilogue: a producer thread keeps the ring (as
//     many boxes as shared memory holds beside the planes, 72 to 144 KB)
//     full, and a consumer warp releases a box once the products that read
//     it are issued: their issue waits for every lane's loads of the box,
//     and every value loaded from it feeds a fragment, so no load of the
//     box is in flight when the next one may land. (Released right after
//     the loads, before the products, behind a block-scope fence, the next
//     box still landed under the backward's reads: other bits in a few rows
//     in 1 to 4 of 4 launches at 65,536 and 262,144 rows of C = 192 on an
//     H100.)
//   - The x values the forward's and the norm's epilogues need come from
//     those same loads (load_step) and stay in registers for the tile. A
//     float32 fragment's k slots t4 and t4 + 4 hold channels 2 t4 and
//     2 t4 + 1 of each k-step (gamma's P planes are written in the same
//     slot order), so one 8-byte load of a row gives a lane both of its
//     slots' values, which are also x at the accumulator's positions: no
//     exchange within the quad, and on an H100 the outputs' bits are those
//     of the slots in channel order. (Reading x again from L2 in the
//     epilogue, at the 16 bytes a lane stores, measured slower on an H100
//     even with the loads issued under the tile's last products: the
//     forward at 4,718,592 rows of float32 C = 192 4.2-4.4 ms against
//     3.4-3.7.) The epilogues write from registers to device memory, after
//     an exchange within each quad that gives a lane 16 contiguous bytes
//     (or 4 bf16 channels), so no store reads the ring either. The
//     backward's read their other operands (g; x and d1) straight from
//     device memory at those positions, prefetched into L2 when the tile
//     starts, every load of a group issued before any is used.
//   - The consumer warpgroups share each tile, 64 rows each. A consumer runs
//     M = 64 wgmma (m64nNBk8 TF32, m64nNBk16 bf16) and builds the next split
//     fragments (a box's in the forward, a k-step's in the backward) while
//     the previous ones' products run, or, where registers allow one set
//     only (the forward at float32 192 and bfloat16 256), overlaps the other
//     consumers' products instead. The forward runs three consumers (the
//     wgmma of one hides behind another's); the backward's launches two:
//     ptxas holds a kernel of 512 threads to 128 registers a thread, and
//     three consumers' products and epilogue loads spilled there (1.3 to
//     1.8 KB a thread at 192). Block rank is a template parameter of the
//     consumer loop, so which boxes hold the block's own output channels,
//     and where, is known when it is compiled.
//   - gamma's planes are the consumers' first work, while rank 0's first
//     boxes are in flight: each thread loads four 16-byte chunks' values of
//     gamma before it splits them into the planes, one conflict-free store
//     a chunk and plane, and the consumers meet on a barrier of their own
//     before their first product.
//   - 384 or 512 threads: the consumers and a producer warpgroup, which
//     hands its registers to them (setmaxnreg: 40 a thread for the
//     producer, 232 or 152 for the consumers, from the 168 or 128 of the
//     launch).
//   - The grid is as many clusters as the card holds at once
//     (cudaOccupancyMaxActiveClusters; H100's GPCs do not all hold the same
//     number: 66 clusters of 2, 30 of 4), at most one a tile, launched with
//     cudaLaunchKernelEx and the cluster dimension. Rank 0's producer waits
//     for the last releases of every stage before it exits, so no remote
//     arrival lands on a block that is gone.
//
// The split and its precision are mix_rows': 3xTF32 (float32 x) or exact
// 3xbf16 (bfloat16 x), float32 accumulate; csrc/gdn_kernel.cu says why.

#pragma once

#include "gdn_wgmma.cuh"

namespace {

constexpr int WIDE_MIN_RING = 64 * 1024;  // bytes of x the ring holds at least

// The launches on the loop, each with its epilogue: the forward, the
// backward's norm (the forward's product; t and d1 out) and its mix (u =
// t . gamma^T over float32 t tiles; dx out); and the backward's fused
// launch at CP = 128 (both products, t exchanged within the cluster; dx,
// and t where the dgamma/dbeta stage reads it, out).
enum WideLaunch { WIDE_FORWARD, WIDE_NORM, WIDE_MIX, WIDE_BACKWARD };

// Blocks per cluster: the fewest whose gamma slices (hi and lo planes) fit
// beside a ring of at least 64 KB. esz: the ring's element size (4 for the
// mix, whose tiles are float32 t). The fused launch at CP = 128: two, each
// holding both layouts of its 64 channels (P and Q planes, 4 x 32 KB for
// float32 x), which one block cannot hold for all 128 beside a ring.
constexpr int wide_cluster_of(int esz, int cp) { return esz == 4 && cp == 256 ? 4 : 2; }
// Consumer warpgroups a block, each taking 64 rows of a tile. The forward:
// three (the wgmma of one hides behind another's: float32 256 takes a
// third less time with three than with two on an H100, float32 192 up to
// a tenth less, with one fragment set). The backward's norm and mix: two,
// whose 168 registers a thread hold the accumulator, two fragment sets and
// a group of the epilogue's loads without spilling. tools/gdn_variants.py
// with tools/gdn_wide_variants.json times these choices undone (PERF.md
// §6).
constexpr int wide_consumers_of(int esz, int cp, int launch) {
  return launch != WIDE_FORWARD ? 2 : 3;
}
// Sets of split fragments a consumer holds: two let it build the next
// set's while the products of this one run; the forward keeps one where
// its accumulator and x leave no room for two in the 128 registers ptxas
// gives a thread of a 512-thread kernel (float32 192: 48 + 48, bfloat16
// 256: 64 + 32), and its three consumers overlap each other instead. The
// fused launch keeps three, two sets' products in flight while it builds
// the third's (2-3.5% faster than two at 98,304 and 262,144 rows of C = 128
// on an H100 80GB HBM3 at 700 W, with no spills in its 168 registers a
// thread).
constexpr int wide_fragment_sets_of(int esz, int cp, int launch) {
  if (launch == WIDE_BACKWARD) return 3;
  return launch == WIDE_FORWARD && ((esz == 4 && cp == 192) || (esz == 2 && cp == 256)) ? 1
                                                                                        : 2;
}
// k-steps (of 4 a box) a fragment set covers, one commit of products a
// set: the forward's sets cover a box; the backward's launches, whose two
// consumers leave the tensor cores idle more often, one k-step, so that a
// consumer's next products are issued sooner (the mix at 262,144 rows of
// float32 C = 192 3.5% faster on an H100; the forward's bfloat16 rows 2-3%
// slower so).
constexpr int wide_fragment_steps_of(int esz, int cp, int launch) {
  return launch == WIDE_FORWARD ? 4 : 1;
}
// Rows of a tile (and of the ring's TMA box) at width c.
constexpr int wide_tile_rows(int esz, int c, int launch) {
  return ROWS * wide_consumers_of(esz, (c + 63) / 64 * 64, launch);
}

// T: the ring's type (x's; float32 t for the mix); CP: C padded to 192 or
// 256 (128 for the fused launch).
template <typename T, int CP_, int LAUNCH = WIDE_FORWARD>
struct Wide {
  using Elem = T;
  static constexpr int CP = CP_;
  static constexpr bool MIX = LAUNCH == WIDE_MIX;  // Q planes, the tiles not squared
  static constexpr bool FUSED = LAUNCH == WIDE_BACKWARD;  // P and Q planes, t exchanged
  static constexpr int ESZ = sizeof(T);
  // gamma's P planes of float32 x hold each k-step's channels in x's pair
  // order (wide_slot_channel)
  static constexpr bool PAIR_SLOTS = ESZ == 4 && !MIX;
  static constexpr int COLS = BOX_BYTES / ESZ;           // channels per box: 32 or 64
  static constexpr int BOXES = CP / COLS;                // K blocks per tile
  static constexpr int KSTEPS = 4;                       // wgmma k-steps (32 bytes) per box
  static constexpr int S = wide_cluster_of(ESZ, CP);
  static constexpr int NB = CP / S;                      // output channels per block
  static constexpr int CONSUMERS = wide_consumers_of(ESZ, CP, LAUNCH);
  static constexpr int THREADS = 128 * (CONSUMERS + 1);  // + the producer warpgroup
  static constexpr int TILE_ROWS = ROWS * CONSUMERS;
  static constexpr int BOX = TILE_ROWS * BOX_BYTES;      // one stage: one K block of a tile
  // registers a thread after setmaxnreg: the producer's 40 go to the consumers
  // (a block starts with the registers of its launch, 65536 / THREADS a
  // thread in multiples of 8; setmaxnreg only moves them between warpgroups)
  static constexpr int PRODUCER_REGS = 40;
  static constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
  static constexpr int SHARED_REGS =
      (LAUNCH_REGS * (CONSUMERS + 1) - PRODUCER_REGS) / CONSUMERS / 8 * 8;
  static constexpr int CONSUMER_REGS = SHARED_REGS < 232 ? SHARED_REGS : 232;
  static constexpr int FRAGS = wide_fragment_sets_of(ESZ, CP, LAUNCH);
  static constexpr int FRAG_STEPS = wide_fragment_steps_of(ESZ, CP, LAUNCH);
  static constexpr int PLANE_BYTES = NB * CP * ESZ;      // one gamma plane
  // the fused launch's Q planes (TF32 hi and lo, whatever x's type: the
  // mix's operand is float32 t) and its exchange buffers: a consumer's t
  // for the partner, one float32 value a thread for each of its NB / 2
  // accumulator elements
  static constexpr int Q_PLANE_BYTES = FUSED ? NB * CP * 4 : 0;
  static constexpr int XCH_WG_BYTES = FUSED ? 128 * (NB / 2) * 4 : 0;
  static constexpr int XCH_BYTES = CONSUMERS * XCH_WG_BYTES;
  static constexpr int STAGES =
      (SMEM_LIMIT - SMEM_RESERVE - 2 * PLANE_BYTES - 2 * Q_PLANE_BYTES - XCH_BYTES) / BOX;
  // each consumer warp of each block releases every stage
  static constexpr int RELEASES = 4 * CONSUMERS * S;
  // the fused launch's exchange barriers: "xfull" and "xfree" a consumer
  static constexpr int XBARS = FUSED ? 2 * CONSUMERS : 0;
  static constexpr int SMEM = 1024 + 2 * PLANE_BYTES + 2 * Q_PLANE_BYTES + XCH_BYTES +
                              STAGES * BOX + NB * 4 + (2 * STAGES + XBARS) * 8;
  static_assert(FUSED ? CP == 128 : (CP == 192 || CP == 256),
                "the wide loop serves CP 192 and 256, the fused launch CP 128");
  static_assert(!FUSED || (S == 2 && NB == 64), "the fused launch: two blocks of 64 channels");
  static_assert(!MIX || ESZ == 4, "the mix's tiles are float32 t");
  static_assert(S >= 2 && CP % S == 0 && NB % (ESZ == 4 ? 16 : 32) == 0 && NB <= 128,
                "S; NB: a wgmma N, whole 16-byte pieces of the epilogue's quads");
  static_assert(STAGES * BOX >= WIDE_MIN_RING, "a ring of at least 64 KB");
  static_assert(SMEM <= SMEM_LIMIT, "shared memory");
  static_assert(PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <= LAUNCH_REGS * (CONSUMERS + 1) &&
                    CONSUMER_REGS >= LAUNCH_REGS,
                "setmaxnreg: the consumers take no more than the producer gives");
};

// The geometry each instantiation gets (tests/test_torch_kernels.py holds
// ops/kernels/gdn_kernel.py's mirror, `wide_geometry`, to these lines): the
// forward's,
static_assert(Wide<float, 192>::S == 2 && Wide<float, 192>::NB == 96 &&
              Wide<float, 192>::CONSUMERS == 3 && Wide<float, 192>::STAGES == 3 &&
              Wide<float, 192>::SMEM == 222640, "f32 192");
static_assert(Wide<float, 256>::S == 4 && Wide<float, 256>::NB == 64 &&
              Wide<float, 256>::CONSUMERS == 3 && Wide<float, 256>::STAGES == 4 &&
              Wide<float, 256>::SMEM == 230720, "f32 256");
static_assert(Wide<__nv_bfloat16, 192>::S == 2 && Wide<__nv_bfloat16, 192>::NB == 96 &&
              Wide<__nv_bfloat16, 192>::CONSUMERS == 3 && Wide<__nv_bfloat16, 192>::STAGES == 6 &&
              Wide<__nv_bfloat16, 192>::SMEM == 222688, "bf16 192");
static_assert(Wide<__nv_bfloat16, 256>::S == 2 && Wide<__nv_bfloat16, 256>::NB == 128 &&
              Wide<__nv_bfloat16, 256>::CONSUMERS == 3 && Wide<__nv_bfloat16, 256>::STAGES == 4 &&
              Wide<__nv_bfloat16, 256>::SMEM == 230976, "bf16 256");
// the norm's (two consumers; the forward's clusters and widths),
static_assert(Wide<float, 192, WIDE_NORM>::S == 2 && Wide<float, 192, WIDE_NORM>::NB == 96 &&
              Wide<float, 192, WIDE_NORM>::CONSUMERS == 2 &&
              Wide<float, 192, WIDE_NORM>::STAGES == 5 &&
              Wide<float, 192, WIDE_NORM>::SMEM == 230864, "norm f32 192");
static_assert(Wide<float, 256, WIDE_NORM>::S == 4 && Wide<float, 256, WIDE_NORM>::NB == 64 &&
              Wide<float, 256, WIDE_NORM>::CONSUMERS == 2 &&
              Wide<float, 256, WIDE_NORM>::STAGES == 6 &&
              Wide<float, 256, WIDE_NORM>::SMEM == 230752, "norm f32 256");
static_assert(Wide<__nv_bfloat16, 192, WIDE_NORM>::S == 2 &&
              Wide<__nv_bfloat16, 192, WIDE_NORM>::NB == 96 &&
              Wide<__nv_bfloat16, 192, WIDE_NORM>::CONSUMERS == 2 &&
              Wide<__nv_bfloat16, 192, WIDE_NORM>::STAGES == 9 &&
              Wide<__nv_bfloat16, 192, WIDE_NORM>::SMEM == 222736, "norm bf16 192");
static_assert(Wide<__nv_bfloat16, 256, WIDE_NORM>::S == 2 &&
              Wide<__nv_bfloat16, 256, WIDE_NORM>::NB == 128 &&
              Wide<__nv_bfloat16, 256, WIDE_NORM>::CONSUMERS == 2 &&
              Wide<__nv_bfloat16, 256, WIDE_NORM>::STAGES == 6 &&
              Wide<__nv_bfloat16, 256, WIDE_NORM>::SMEM == 231008, "norm bf16 256");
// and the mix's (float32 t tiles for either x)
static_assert(Wide<float, 192, WIDE_MIX>::S == 2 && Wide<float, 192, WIDE_MIX>::NB == 96 &&
              Wide<float, 192, WIDE_MIX>::CONSUMERS == 2 &&
              Wide<float, 192, WIDE_MIX>::STAGES == 5 &&
              Wide<float, 192, WIDE_MIX>::SMEM == 230864, "mix 192");
static_assert(Wide<float, 256, WIDE_MIX>::S == 4 && Wide<float, 256, WIDE_MIX>::NB == 64 &&
              Wide<float, 256, WIDE_MIX>::CONSUMERS == 2 &&
              Wide<float, 256, WIDE_MIX>::STAGES == 6 &&
              Wide<float, 256, WIDE_MIX>::SMEM == 230752, "mix 256");
// and the backward's fused launch at CP = 128 (P planes in x's type, Q
// planes TF32, the exchange buffers: float32 x leaves one tile of ring)
static_assert(Wide<float, 128, WIDE_BACKWARD>::S == 2 &&
              Wide<float, 128, WIDE_BACKWARD>::NB == 64 &&
              Wide<float, 128, WIDE_BACKWARD>::CONSUMERS == 2 &&
              Wide<float, 128, WIDE_BACKWARD>::STAGES == 4 &&
              Wide<float, 128, WIDE_BACKWARD>::SMEM == 230752, "backward f32 128");
static_assert(Wide<__nv_bfloat16, 128, WIDE_BACKWARD>::S == 2 &&
              Wide<__nv_bfloat16, 128, WIDE_BACKWARD>::NB == 64 &&
              Wide<__nv_bfloat16, 128, WIDE_BACKWARD>::CONSUMERS == 2 &&
              Wide<__nv_bfloat16, 128, WIDE_BACKWARD>::STAGES == 6 &&
              Wide<__nv_bfloat16, 128, WIDE_BACKWARD>::SMEM == 230784, "backward bf16 128");

// --- cluster PTX ----------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_id_x() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_count_x() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return r;
}
// The warpgroup's registers a thread, lowered (the producer) or raised (the
// consumers) from the 168 that 384 threads start with.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}
// Every thread of every block of the cluster arrives, then waits for the rest.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// One arrival on the mbarrier at the same offset as `bar` in the block of
// rank `rank`, ordered after this thread's earlier accesses at the
// default (block) scope: it tells the producer that this warp has read a
// stage of its own block (the caller makes sure its lanes' loads from the
// stage are complete first). A cluster-scope release would also wait for
// the warp's earlier stores to device memory (the last tile's outputs):
// about 1.4x slower at C = 192 on an H100.
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n"
      :: "r"(bar), "r"(rank) : "memory");
}
// The address of `addr` (this block's shared memory) in the block of rank
// `rank`, in the cluster's shared memory window.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
// 16 bytes into another block's shared memory (`remote`, from mapa), their
// arrival counted in bytes on that block's mbarrier `remote_bar` (which its
// owner armed with mbar_expect_tx): no fence and no arrival of the writer's.
__device__ __forceinline__ void st_async(uint32_t remote, float a, float b, float c, float d,
                                         uint32_t remote_bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" :: "r"(remote), "f"(a), "f"(b), "f"(c), "f"(d), "r"(remote_bar) : "memory");
}
// mbar_wait for a barrier that other blocks' threads arrive on.
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT_CLUSTER:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_CLUSTER;\n}\n" :: "r"(bar), "r"(parity) : "memory");
}
// A box into the same shared-memory offset of every block in `mask`, each
// block's mbarrier at `bar`'s offset told of its bytes.
__device__ __forceinline__ void tma_load_multicast(uint32_t dst, const CUtensorMap* map,
                                                   uint32_t bar, int c0, int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask), "r"(c0), "r"(c1)
      : "memory");
}

// --- the consumers ----------------------------------------------------------------

// The A fragments of k-step ks of box kc (4 registers of hi and of lo): for
// the forward and the norm x squared and split, and from the same loads x
// at the accumulator's positions among the block's channels N0 + [0, NB)
// (element 4j + 2h + e (float32) or bf16 pair 2j + h: row ra + 8h, channel
// N0 + 8j + 2 t4 + e); for the mix t split as it is. Called from the
// unrolled box loop, so kc, ks and j are constants and xs stays in
// registers. Every value loaded from the box goes into a fragment, so the
// products' issue that follows waits for all of the k-step's loads.
//
// float32 x: a TF32 k-step takes 8 channels, and the fragment's k slots t4
// and t4 + 4 hold channels 2 t4 and 2 t4 + 1 of it (gamma's P planes are
// written in the same order, wide_slot_channel, so each product takes the
// same terms), so one 8-byte load of a row gives a lane both of its slots'
// values, and they are x at the accumulator's positions too: no exchange
// within the quad. bfloat16 x: a k-step of 16 channels, the lane's pairs at
// 2 t4 and 8 + 2 t4, which are the accumulator's positions. float32 t (the
// mix, Q planes in channel order): slots t4 and t4 + 4 are channels t4 and
// t4 + 4, as load_a reads them.
template <typename W, int N0, typename XReg>
__device__ __forceinline__ void load_step(const uint8_t* box, int kc, int ks, int ra, int t4,
                                          uint32_t* hi, uint32_t* lo, XReg* xs) {
  if constexpr (W::MIX) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float v = *reinterpret_cast<const float*>(
          box + swz(ra + 8 * (q & 1), 4 * (8 * ks + t4 + 4 * (q >> 1))));
      const uint32_t h = tf32_rna(v);
      hi[q] = h;
      lo[q] = tf32_rna(v - __uint_as_float(h));
    }
  } else if constexpr (W::ESZ == 4) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 v =
          *reinterpret_cast<const float2*>(box + swz(ra + 8 * h, 4 * (8 * ks + 2 * t4)));
      // fragment register q: row ra + 8 (q & 1), slot t4 + 4 (q >> 1)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float s = e ? v.y * v.y : v.x * v.x;
        const uint32_t hs = tf32_rna(s);
        hi[2 * e + h] = hs;
        lo[2 * e + h] = tf32_rna(s - __uint_as_float(hs));
      }
      const int c8 = 32 * kc + 8 * ks;  // the k-step's first channel
      if (c8 >= N0 && c8 < N0 + W::NB) {
        xs[4 * ((c8 - N0) / 8) + 2 * h] = v.x;
        xs[4 * ((c8 - N0) / 8) + 2 * h + 1] = v.y;
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = ra + 8 * (q & 1);
      const int col = 16 * ks + 2 * t4 + 8 * (q >> 1);
      const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(box + swz(row, 2 * col));
      const __nv_bfloat162 h = __hmul2(x, x);
      hi[q] = bf16x2_bits(h);
      lo[q] = bf16x2_bits(__hfma2(x, x, __hneg2(h)));
      // channels c8 + 2 t4 + {0, 1} of row ra + 8 (q & 1): pair 2 j + (q & 1)
      const int c8 = 64 * kc + 16 * ks + 8 * (q >> 1);
      if (c8 >= N0 && c8 < N0 + W::NB) xs[2 * ((c8 - N0) / 8) + (q & 1)] = bf16x2_bits(x);
    }
  }
}

// 16 bytes of gamma's hi and lo planes from 4 (float32: TF32 hi and lo) or
// 8 (bfloat16: bf16 hi and lo) values, as split_store splits each.
__device__ __forceinline__ void split_store_chunk(float, uint8_t* hi, uint8_t* lo,
                                                  const float* g) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    h[j] = tf32_rna(g[j]);
    l[j] = tf32_rna(g[j] - __uint_as_float(h[j]));
  }
  *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
}
__device__ __forceinline__ void split_store_chunk(__nv_bfloat16, uint8_t* hi, uint8_t* lo,
                                                  const float* g) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const __nv_bfloat162 hv = __floats2bfloat162_rn(g[2 * j], g[2 * j + 1]);
    const float2 hf = __bfloat1622float2(hv);
    h[j] = bf16x2_bits(hv);
    l[j] = bf16x2_bits(__floats2bfloat162_rn(g[2 * j] - hf.x, g[2 * j + 1] - hf.y));
  }
  *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(lo) = make_uint4(l[0], l[1], l[2], l[3]);
}

// The input channel that k slot s of gamma's planes holds: the float32 P
// planes (the forward's and the norm's) and the fused launch's Q planes
// (PAIR_SLOTS) in load_step's order within each k-step of 8, every other
// plane in channel order.
template <typename W>
__device__ __forceinline__ int wide_slot_channel(int s) {
  if constexpr (W::PAIR_SLOTS) {
    return (s & ~7) | ((s & 3) << 1) | ((s >> 2) & 1);
  } else {
    return s;
  }
}

// The exchange within a quad (the 4 lanes of a row) that turns a lane's 4
// accumulator-layout values of 16 channels (a[0..1] at 2 t4 + {0, 1},
// a[2..3] at 8 + 2 t4 + {0, 1}) into 4 neighbouring channels,
// quad_channel(t4) + [0, 4): lane bit 0 swapped with a's index bit 1.
__device__ __forceinline__ int quad_channel(int t4) { return 8 * (t4 & 1) + 4 * (t4 >> 1); }
__device__ __forceinline__ void quad_swap(float* a, bool odd) {
  const float s0 = __shfl_xor_sync(0xffffffffu, odd ? a[0] : a[2], 1);
  const float s1 = __shfl_xor_sync(0xffffffffu, odd ? a[1] : a[3], 1);
  if (odd) {
    a[0] = s0;
    a[1] = s1;
  } else {
    a[2] = s0;
    a[3] = s1;
  }
}

template <bool INVERSE>
__device__ __forceinline__ float wide_scale(float norm) {
  float r;
  if (INVERSE) {
    asm("sqrt.approx.f32 %0, %1;\n" : "=f"(r) : "f"(norm));
  } else {
    r = rsqrtf(norm);
  }
  return r;
}

// The forward's epilogue of one warpgroup's 64 rows: out = x * rsqrt(acc +
// beta) (or sqrt) over the block's channels N0 + [0, NB), written from
// registers in 16-byte pieces. In the accumulator's layout a quad (4 lanes)
// holds a row in pieces of 8 (float32) or 4 (bf16) bytes; one (float32,
// quad_swap) or two (bf16) exchanges within the quad give each lane 16
// contiguous bytes, so a warp's store covers 64 contiguous bytes of each of
// 8 rows (two whole sectors). x comes from the box loop's registers, in
// the accumulator's layout (xs). Rows are masked to n_rows, channels to c
// (a multiple of 4 for float32, 8 for bf16, so a 16-byte piece is all in
// or all out).
//
// float32: the products in the accumulator's layout, then exchanged.
template <bool INVERSE, int NB, int N0>
__device__ __forceinline__ void put_out(float* out, const float* acc, const float* xs,
                                        const float* beta_s, long long row, int t4, int n_rows,
                                        int c) {
  const bool odd = t4 & 1;
#pragma unroll
  for (int jp = 0; jp < NB / 16; ++jp) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // a: channels 16 jp + 2 t4 + {0, 1} and 16 jp + 8 + 2 t4 + {0, 1}
      float a[4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int v = 4 * (2 * jp + jj) + 2 * h;
        const float2 b = *reinterpret_cast<const float2*>(beta_s + 16 * jp + 8 * jj + 2 * t4);
        a[2 * jj] = xs[v] * wide_scale<INVERSE>(acc[v] + b.x);
        a[2 * jj + 1] = xs[v + 1] * wide_scale<INVERSE>(acc[v + 1] + b.y);
      }
      quad_swap(a, odd);
      const int col = N0 + 16 * jp + quad_channel(t4);
      if (row + 8 * h < n_rows && col < c) {
        *reinterpret_cast<float4*>(out + (row + 8 * h) * c + col) =
            make_float4(a[0], a[1], a[2], a[3]);
      }
    }
  }
}
// bfloat16, x as bf16 pairs in the accumulator's layout: the outputs
// rounded to bf16 pairs, then a 4 x 4 transpose within the quad.
template <bool INVERSE, int NB, int N0>
__device__ __forceinline__ void put_out(__nv_bfloat16* out, const float* acc, const uint32_t* xs,
                                        const float* beta_s, long long row, int t4, int n_rows,
                                        int c) {
#pragma unroll
  for (int jq = 0; jq < NB / 32; ++jq) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // a[k]: channels 32 jq + 8 k + 2 t4 + {0, 1}, a bf16 pair
      uint32_t a[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = 4 * jq + k;
        const float2 b = *reinterpret_cast<const float2*>(beta_s + 8 * j + 2 * t4);
        const uint32_t w = xs[2 * j + h];
        const float x0 = __uint_as_float(w << 16), x1 = __uint_as_float(w & 0xffff0000u);
        a[k] = bf16x2_bits(__floats2bfloat162_rn(
            x0 * wide_scale<INVERSE>(acc[4 * j + 2 * h] + b.x),
            x1 * wide_scale<INVERSE>(acc[4 * j + 2 * h + 1] + b.y)));
      }
      // a 4 x 4 transpose within the quad (swap lane bit 0 with index bit 0,
      // then bit 1 with bit 1): lane t4 then holds channels 32 jq + 8 t4 + [0, 8)
      const bool b0 = t4 & 1, b1 = t4 & 2;
      uint32_t r0 = __shfl_xor_sync(0xffffffffu, b0 ? a[0] : a[1], 1);
      uint32_t r1 = __shfl_xor_sync(0xffffffffu, b0 ? a[2] : a[3], 1);
      if (b0) {
        a[0] = r0;
        a[2] = r1;
      } else {
        a[1] = r0;
        a[3] = r1;
      }
      r0 = __shfl_xor_sync(0xffffffffu, b1 ? a[0] : a[2], 2);
      r1 = __shfl_xor_sync(0xffffffffu, b1 ? a[1] : a[3], 2);
      if (b1) {
        a[0] = r0;
        a[1] = r1;
      } else {
        a[2] = r0;
        a[3] = r1;
      }
      const int col = N0 + 32 * jq + 8 * t4;
      if (row + 8 * h < n_rows && col < c) {
        *reinterpret_cast<uint4*>(out + (row + 8 * h) * c + col) =
            make_uint4(a[0], a[1], a[2], a[3]);
      }
    }
  }
}

// The forward's epilogue: put_out into out (n_rows x c, x's type).
template <typename T, bool INVERSE>
struct WideForwardOut {
  T* out;
  int c;

  template <int NB, int N0>
  __device__ __forceinline__ void prefetch(long long, int, int) const {}

  template <int NB, int N0, typename XReg>
  __device__ __forceinline__ void put(const float* acc, const XReg* xs, const float* beta_s,
                                      long long row, int t4, int n_rows) const {
    put_out<INVERSE, NB, N0>(out, acc, xs, beta_s, row, t4, n_rows, c);
  }
};

// The x values a consumer keeps for its epilogue (load_step's xs):
// float32 values or bf16 pairs in the accumulator's layout, none for the mix.
template <typename W>
using WideXReg = typename std::conditional<W::ESZ == 4, float, uint32_t>::type;
template <typename W>
__host__ __device__ constexpr int wide_xregs() {
  return W::MIX ? 1 : W::ESZ == 4 ? W::NB / 2 : W::NB / 4;
}

// One tile's acc = A . B over the ring, box by box (A: the tile squared, or
// as it is for the mix, from load_step; B: gamma's planes at hi_base,
// lo_base), each box released to rank 0's "empty" once the products that
// read it are issued; stage and phase walk the ring. Leaves the products in
// flight: the caller waits for them.
template <typename W, int N0>
__device__ __forceinline__ void wide_products(const uint8_t* ring, const uint64_t* full,
                                              uint32_t empty0, uint32_t hi_base,
                                              uint32_t lo_base, int ra, int t4, float* acc,
                                              WideXReg<W>* xs, int& stage, uint32_t& phase) {
  using T = typename W::Elem;
  const int wg = threadIdx.x / 128;
  uint32_t a_hi[W::FRAGS][4 * W::FRAG_STEPS], a_lo[W::FRAGS][4 * W::FRAG_STEPS];
#pragma unroll
  for (int v = 0; v < W::NB / 2; ++v) {
    acc[v] = 0.0f;
    fence_operand(acc[v]);
  }
#pragma unroll
  for (int kc = 0; kc < W::BOXES; ++kc) {
    mbar_wait(smem_u32(&full[stage]), phase);
    const uint8_t* box = ring + stage * W::BOX + wg * BOX_TILE_BYTES;
    // the box's k-steps in groups of FRAG_STEPS, one commit a group
#pragma unroll
    for (int k0 = 0; k0 < W::KSTEPS; k0 += W::FRAG_STEPS) {
      const int u = (kc * W::KSTEPS + k0) / W::FRAG_STEPS;  // the tile's group
      // the products that read this fragment set are done
      if (u >= W::FRAGS) wgmma_wait<W::FRAGS - 1>();
      uint32_t* hi = a_hi[u % W::FRAGS];
      uint32_t* lo = a_lo[u % W::FRAGS];
#pragma unroll
      for (int ks = 0; ks < W::FRAG_STEPS; ++ks) {
        load_step<W, N0>(box, kc, k0 + ks, ra, t4, hi + 4 * ks, lo + 4 * ks, xs);
      }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < W::FRAG_STEPS; ++ks) {
        const uint32_t off = kc * (W::NB * BOX_BYTES) + (k0 + ks) * 32;
        const uint64_t b_hi = desc_b128(hi_base + off), b_lo = desc_b128(lo_base + off);
        mma<T, W::NB>(acc, lo + 4 * ks, b_hi);
        mma<T, W::NB>(acc, hi + 4 * ks, b_lo);
        mma<T, W::NB>(acc, hi + 4 * ks, b_hi);
      }
      wgmma_commit();
    }
    // the products' issue has waited for each lane's loads of the box:
    // the warp is done with it, one arrival on rank 0's "empty"
    __syncwarp();
    if (threadIdx.x % 32 == 0) mbar_arrive_remote(empty0 + 8 * stage, 0);
    if (++stage == W::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
}

// The consumer warpgroups of the block of rank RANK: each takes 64 rows of
// every tile of the cluster, whose box i sits in stage i % STAGES. For each
// tile, epi.prefetch<NB, N0>(row, t4, n_rows) (the epilogue's operands in
// device memory into L2, where it has any), acc = A . gamma[:, slice] box
// by box (A: the tile squared, or as it is for the mix), then the launch's
// epilogue, epi.put<NB, N0>(acc, xs, beta_s, row, t4, n_rows): the
// accumulator (element 4j + 2h + e: row row + 8h, channel N0 + 8j + 2 t4 +
// e), x at the same positions (float32 values or bf16 pairs from load_step;
// unset for the mix), beta of the block's channels, the warp's rows and
// the lane's quad index.
template <typename W, int RANK, typename Epilogue>
__device__ __forceinline__ void wide_consume(const uint8_t* ring, const uint64_t* full,
                                             uint32_t empty0, uint32_t hi_base,
                                             uint32_t lo_base, const float* beta_s,
                                             const Epilogue& epi, int n_rows, int tile0,
                                             int tile_step, int tiles) {
  constexpr int N0 = RANK * W::NB;
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int ra = ((threadIdx.x / 32) % 4) * 16 + lane / 4;  // rows ra and ra + 8
  const int t4 = lane % 4;
  float acc[W::NB / 2];
  WideXReg<W> xs[wide_xregs<W>()];
  int stage = 0;
  uint32_t phase = 0;

  for (int tile = tile0; tile < tiles; tile += tile_step) {
    const long long row = static_cast<long long>(tile) * W::TILE_ROWS + wg * ROWS + ra;
    epi.template prefetch<W::NB, N0>(row, t4, n_rows);
    wide_products<W, N0>(ring, full, empty0, hi_base, lo_base, ra, t4, acc, xs, stage, phase);
    wgmma_wait<0>();
#pragma unroll
    for (int v = 0; v < W::NB / 2; ++v) fence_operand(acc[v]);

    epi.template put<W::NB, N0>(acc, xs, beta_s, row, t4, n_rows);
  }
}

template <typename W, typename Epilogue, int RANK = 0>
__device__ __forceinline__ void wide_consume_rank(int rank, const uint8_t* ring,
                                                  const uint64_t* full, uint32_t empty0,
                                                  uint32_t hi_base, uint32_t lo_base,
                                                  const float* beta_s, const Epilogue& epi,
                                                  int n_rows, int tile0, int tile_step,
                                                  int tiles) {
  if constexpr (RANK < W::S) {
    if (rank == RANK) {
      wide_consume<W, RANK>(ring, full, empty0, hi_base, lo_base, beta_s, epi, n_rows, tile0,
                            tile_step, tiles);
    } else {
      wide_consume_rank<W, Epilogue, RANK + 1>(rank, ring, full, empty0, hi_base, lo_base,
                                               beta_s, epi, n_rows, tile0, tile_step, tiles);
    }
  }
}

// --- the kernels ------------------------------------------------------------------

// gamma's planes of the block's output channels n0 + [0, NB) as wgmma's B,
// zero padded: row o (output channel n0 + o) holds the input channels k in
// the slot order of wide_slot_channel; P reads gamma[k][n0 + o], Q gamma[n0
// + o][k]. beta of the slice, ones past c (not for the mix). The planes are
// written in 16-byte chunks of a row's slots (4 float32 or 8 bf16), one
// store to each plane a chunk, conflict-free through the swizzle: for P
// neighbouring threads take neighbouring rows (their loads of gamma
// neighbouring output channels), for Q neighbouring chunks of a row.
// Thread `first` of STRIDE takes every STRIDE-th chunk, GROUP chunks'
// loads of gamma in flight before it splits and stores them.
template <typename W, int STRIDE>
__device__ __forceinline__ void wide_gamma(int first, uint8_t* g_hi, uint8_t* g_lo,
                                           float* beta_s, const float* __restrict__ gamma,
                                           const float* __restrict__ beta, int n0, int c) {
  constexpr int V = 16 / W::ESZ;               // slots a chunk
  constexpr int CHUNKS = W::NB * (W::CP / V);  // chunks of one plane
  constexpr int GROUP = 4;
  for (int base = first; base < CHUNKS; base += GROUP * STRIDE) {
    float g[GROUP][V];
#pragma unroll
    for (int i = 0; i < GROUP; ++i) {
      const int q = base + i * STRIDE;
      const int o = W::MIX ? q / (W::CP / V) : q % W::NB;
      const int s0 = V * (W::MIX ? q % (W::CP / V) : q / W::NB);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int k = wide_slot_channel<W>(s0 + j);
        g[i][j] = 0.0f;
        if (q < CHUNKS && k < c && n0 + o < c) {
          g[i][j] = W::MIX ? gamma[static_cast<int64_t>(n0 + o) * c + k]
                           : gamma[static_cast<int64_t>(k) * c + n0 + o];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < GROUP; ++i) {
      const int q = base + i * STRIDE;
      const int o = W::MIX ? q / (W::CP / V) : q % W::NB;
      const int s0 = V * (W::MIX ? q % (W::CP / V) : q / W::NB);
      if (q < CHUNKS) {
        const uint32_t off =
            (s0 / W::COLS) * (W::NB * BOX_BYTES) + swz(o, (s0 % W::COLS) * W::ESZ);
        split_store_chunk(typename W::Elem(), g_hi + off, g_lo + off, g[i]);
      }
    }
  }
  if constexpr (!W::MIX) {
    for (int i = first; i < W::NB; i += STRIDE) beta_s[i] = n0 + i < c ? beta[n0 + i] : 1.0f;
  }
}

// The producer warpgroup's one working thread: it arms this block's "full"
// barrier for each box; in rank 0 it also waits until every block released
// the stage and sends the box to all of them (rows of in_map, W's type,
// boxes of a tile's rows x 128 bytes).
template <typename W>
__device__ __forceinline__ void wide_produce(const CUtensorMap* in_map, const uint8_t* ring,
                                             uint64_t* full, uint64_t* empty, int rank,
                                             int tile0, int tile_step, int tiles) {
  const uint32_t ring_u32 = smem_u32(ring);
  const uint16_t mask = static_cast<uint16_t>((1u << W::S) - 1);
  int stage = 0, i = 0;
  uint32_t phase = 0;
  for (int tile = tile0; tile < tiles; tile += tile_step) {
    for (int kc = 0; kc < W::BOXES; ++kc, ++i) {
      const uint32_t full_s = smem_u32(&full[stage]);
      if (rank == 0) {
        if (i >= W::STAGES) mbar_wait_cluster(smem_u32(&empty[stage]), phase ^ 1);
        mbar_expect_tx(full_s, W::BOX);
        const uint32_t dst = ring_u32 + stage * W::BOX;
        tma_load_multicast(dst, in_map, full_s, kc * W::COLS, tile * W::TILE_ROWS, mask);
      } else {
        // the stage's previous box has landed here (so this arrival
        // opens the next phase); its bytes may come before or after it
        if (i >= W::STAGES) mbar_wait(full_s, phase ^ 1);
        mbar_expect_tx(full_s, W::BOX);
      }
      if (++stage == W::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  if (rank == 0) {
    // the last releases of every stage: no block's warp still arrives here
    for (int k = 0; k < W::STAGES; ++k, ++i) {
      if (i >= W::STAGES) mbar_wait_cluster(smem_u32(&empty[stage]), phase ^ 1);
      if (++stage == W::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
}

// The body of every launch on the loop but the fused one (whose body,
// gdn_bwd_fused_kernel, has exchange buffers and a consumer loop of its
// own), over the rows of in_map (n_rows x c, W's type, boxes of a tile's
// rows x 128 bytes): the barriers, then the
// producer warpgroup, which starts filling the ring at once, and the
// consumers, which meanwhile put gamma's planes of the block's output
// channels (P, or Q for the mix) and, but for the mix, beta's into shared
// memory, meet on a barrier of their own and then hand each tile's
// accumulator to `epi`.
template <typename W, typename Epilogue>
__device__ __forceinline__ void wide_rows(const CUtensorMap* in_map,
                                          const float* __restrict__ gamma,
                                          const float* __restrict__ beta, int n_rows, int c,
                                          const Epilogue& epi) {
  extern __shared__ uint8_t smem_raw[];
  // the swizzle is keyed to address bits 7-9: align the boxes to 1024 bytes
  // (the same offset in every block of the cluster, as multicast needs)
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* g_hi = smem;
  uint8_t* g_lo = smem + W::PLANE_BYTES;
  uint8_t* ring = smem + 2 * W::PLANE_BYTES;
  float* beta_s = reinterpret_cast<float*>(ring + W::STAGES * W::BOX);
  uint64_t* full = reinterpret_cast<uint64_t*>(beta_s + W::NB);
  uint64_t* empty = full + W::STAGES;  // used in rank 0 alone

  const int rank = static_cast<int>(cluster_ctarank());
  const int n0 = rank * W::NB;  // first output channel of the block
  const int tile0 = static_cast<int>(cluster_id_x());
  const int tile_step = static_cast<int>(cluster_count_x());
  const int tiles = (n_rows - 1) / W::TILE_ROWS + 1;  // n_rows + TILE_ROWS may overflow

  if (threadIdx.x == 0) {
    for (int s = 0; s < W::STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), W::RELEASES);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every block's barriers exist before any box or remote arrival reaches them
  cluster_sync();

  if (threadIdx.x >= 128 * W::CONSUMERS) {
    setmaxnreg_dec<W::PRODUCER_REGS>();
    if (threadIdx.x == 128 * W::CONSUMERS) {
      wide_produce<W>(in_map, ring, full, empty, rank, tile0, tile_step, tiles);
    }
  } else {
    setmaxnreg_inc<W::CONSUMER_REGS>();
    // gamma while the first boxes are in flight; every consumer's stores
    // are done, and visible to wgmma, before any consumer's first product
    wide_gamma<W, 128 * W::CONSUMERS>(threadIdx.x, g_hi, g_lo, beta_s, gamma, beta, n0, c);
    fence_async_smem();
    named_bar_sync(1, 128 * W::CONSUMERS);
    wide_consume_rank<W>(rank, ring, full, smem_u32(&empty[0]), smem_u32(g_hi), smem_u32(g_lo),
                         beta_s, epi, n_rows, tile0, tile_step, tiles);
  }
}

// The forward: out = x * rsqrt(beta + (x*x) . gamma) (sqrt for IGDN) over
// the rows of x_map (n_rows x c, T), out (n_rows, c) in T.
template <typename T, int CP, bool INVERSE>
__global__ void __launch_bounds__(Wide<T, CP>::THREADS, 1)
gdn_rows_kernel_cluster(const __grid_constant__ CUtensorMap x_map, T* __restrict__ out,
                        const float* __restrict__ gamma, const float* __restrict__ beta,
                        int n_rows, int c) {
  wide_rows<Wide<T, CP>>(&x_map, gamma, beta, n_rows, c, WideForwardOut<T, INVERSE>{out, c});
}

// --- host side ------------------------------------------------------------------

// Launches `kernel` (a wide_rows kernel of geometry W) over n rows:
// clusters of W::S blocks, as many as the card holds at once, at most one a
// tile. `clusters_of` is the instance's own per-device cache of
// that count (its shared-memory opt-in and the occupancy query are taken
// once per device).
template <typename W, typename Kernel, typename... Args>
cudaError_t launch_clusters(Kernel kernel, int* clusters_of, int n, cudaStream_t stream,
                            Args... args) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = W::S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(W::THREADS, 1, 1);
  cfg.dynamicSmemBytes = W::SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (clusters_of[dev] == 0) {
    int sms = 0, clusters = 0;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    W::SMEM)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
            cudaSuccess) {
      return err;
    }
    cfg.gridDim = dim3((sms / W::S) * W::S, 1, 1);
    if ((err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg)) != cudaSuccess) {
      return err;
    }
    if (clusters < 1) return cudaErrorLaunchOutOfResources;
    clusters_of[dev] = clusters;
  }
  const long long tiles = (static_cast<long long>(n) + W::TILE_ROWS - 1) / W::TILE_ROWS;
  const long long clusters = clusters_of[dev] < tiles ? clusters_of[dev] : tiles;
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * W::S), 1, 1);
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace
