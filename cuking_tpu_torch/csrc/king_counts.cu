// KING counters for one (i-panel, j-panel) pair on Hopper (sm_90a): an int8
// tensor-core (wgmma) kernel that unpacks the packed het/hom words on chip,
// with its warpgroups specialised (one loads and unpacks, two multiply) and
// its CTAs paired in clusters that share the unpacked j rows.
//
// Replaces: cuking_tpu/ops/king_pallas.py `_king_body`, reached through
// `panel_counts_pallas` (sliced panels) and `_panel_counts_pallas_indexed`
// (row offsets into the full storage).  Both entries of the port
// (cuking_tpu_torch/ops/king_cuda.py) call `king_counts_launch` with a base
// pointer and a row offset per side.  It is the file's one kernel, and
// `king_counts_launch` and `king_emit_launch` (king_emit.cu) are the
// library's two C entries.  The kernel's first body, in which all eight
// warps loaded, unpacked B, built A and issued the products in turn around a
// CTA barrier every four words, ran at ~49% of the bound below; the
// warp-specialised one CTA at a time, at ~73%.
//
// What it computes.  Planes are [2, rows, W] 32-bit words (plane 0 = het,
// plane 1 = hom; (1,1) = missing).  Per site, with het bit e and hom bit o:
//   H = e & ~o (het)   v = ~e (hom-ref or hom-alt)   u = A - R in {-1, 0, +1}
// where A = ~e & o (hom-alt) and R = ~e & ~o (hom-ref).  With XY := X_i . Y_j
// summed over sites, the six KING counters are
//   both_het = HH            het_i = HH + Hv         het_j = HH + vH
//   shared   = HH + Hv + vH + vv
//   opposing = (vv - uu) / 2 concordant = (vv + uu) / 2
// because vv = AA + AR + RA + RR and uu = AA - AR - RA + RR.  Missing and
// padding sites give H = v = u = 0 and add nothing.  Five int8 products
// (10 operations per pair and site) replace the TPU kernel's 3x3-block Gram
// over H/A/D (18 operations).  Sums are int32; the epilogue forms vv +- uu
// in uint32, so it stays exact below 2^31 sites.
//
// What bounds it.  At the engine's shape (1024 x 1024 pairs x 100,096 sites)
// the five products are 1.05e12 int8 operations: 0.530 ms at the card's
// 1,979 dense int8 TOP/s.  The bytes are no limit: 51 MB of planes in and
// 25 MB of counters out take 0.023 ms at 3.35 TB/s.  So the tensor cores
// bound it: a CTA's 128 x 64 x 5 products of one word are 320 of their
// clocks.  Beside them run the unpack (integer work), the loads, and shared
// memory's traffic, of which the tensor cores' own reads of B take half at
// their full rate.  The design keeps all of that off the warps that issue
// the products, and shares the unpack between two CTAs:
//
// * The unpacked indicators never touch device memory.  A k32 step is one
//   32-bit word.  K bytes 4c..4c+3 of a word come from bits c, c+8, c+16,
//   c+24 (c = 0..7; any bijection works, since only the Gram matters), so
//   one indicator register is `(word >> c) & 0x01010101`, and
//   u = v + R * 0xFE is 1 for hom-alt and 0xFF for hom-ref with no byte
//   carries: six integer operations give the H, v and u registers of one c.
// * A CTA owns a 128 x 64 pair tile, so a 1024 x 1024 step is 128 CTAs: one
//   wave on 132 SMs at one CTA per SM.  Taller tiles would leave more SMs
//   idle (192 rows: 96 CTAs, 73% of the SMs); a wider one would need more
//   than the 160 accumulators a thread holds for 64 columns.  Its 384
//   threads are three warpgroups.
// * Clusters of two CTAs along i (blockIdx.y 2k and 2k + 1, the grid's i
//   tiles rounded up to whole clusters) share blockIdx.x and so the j tile.
//   Each CTA loads and unpacks only its half of the j rows (rank r: rows
//   32r..32r+31) and hands it to the other, so a product needs half the
//   unpack it did with one CTA per tile; both CTAs multiply the whole tile.
//   The card holds 66 such clusters at once (cudaOccupancyMaxActiveClusters
//   on an H100 80GB HBM3), so a step stays one wave.
// * The producer warpgroup (24 registers after `setmaxnreg.dec`) keeps an
//   8-stage ring of packed 4-word row slices loading as two tensor-map boxes
//   a stage (its 128 i rows, its 32 j rows; the maps are encoded on the host
//   once per storage and box and kept), each completing on its stage's
//   mbarrier; W need only be a multiple of 4, so no K tail exists, and the
//   stage 4 ahead is loaded once a stage is unpacked, by the warps in turn.  Warp w unpacks word w of the 32 rows into a 4-stage ring of B
//   (K-major core matrices, 8 rows x 16 bytes, no swizzle), then hands its
//   3 KB to the peer CTA's same stage with one bulk copy
//   (`cp.async.bulk` shared::cta -> shared::cluster), which completes on the
//   peer's "B full".  The copy keeps the remote stores off the 24-register
//   threads; one thread issuing all 12 KB of a stage, or every producer
//   thread storing into the peer, ran at half the speed.
// * B's layout makes a CTA's half of a word one contiguous run: a word is
//   16 slots of 384 bytes, slot n holding block n of the [H_j; v_j] operand
//   (8 rows, both K halves; the blocks run H of rows 0-31, v of 0-31, H of
//   32-63, v of 32-63, and the epilogue reads the columns in that order)
//   and, in its last 128 bytes, K half n % 2 of u_j's block n / 2.  Rank r's
//   rows fill slots 8r..8r+7; the descriptors take strides of 384 and 768.
// * Two consumer warpgroups (240 registers after `setmaxnreg.inc`) own 64
//   i-rows each and do nothing but build A and issue.  A stays in registers
//   (wgmma's RS form): in the k32 s8 fragment, thread t of a quad holds K
//   bytes 4t..4t+3 and 16+4t..16+4t+3, i.e. c = t and c = t + 4 of rows g
//   and g + 8, built from the packed words (one 8-byte read per row, plane
//   and two words).  Through shared memory A would add ~6 KB of reads a word
//   per warpgroup to B's 64 B a clock and the unpack's writes, near shared
//   memory's 128 B a clock at the tensor cores' full rate.  Per word a
//   warpgroup issues one group: m64n128k32 of H_i against [H_j; v_j]
//   (HH | Hv), the same for v_i (vH | vv) and m64n64k32 of u_i against u_j.
//   Three register sets of A keep two groups in flight while the next word's
//   A is built; with fewer than 240 registers ptxas serialises the groups.
// * No CTA barrier inside the K loop.  Every hand-over is an mbarrier with
//   phase bits: "packed full" (the boxes landed), "packed empty" (every warp
//   has read the stage), "B full" (this CTA's 4 producer warps, behind a
//   proxy fence, and the peer's 12 KB of the stage) and "B empty" (the
//   groups that read the stage have retired, in both CTAs: each consumer
//   warp arrives on its own CTA's and on the peer's).  A producer overwrites
//   its half of a stage, here and in the peer, only once both CTAs' groups
//   have retired it, which also means that its copy out of it has landed.
//   The arrivals and waits are CTA-scope, as a cluster pipeline's consumer
//   releases are: cluster-scope ones on every stage ran ~25% slower.
// * Roles by shape, decided in the kernel from (i0, ni, nj, tri) as
//   king_cuda.cluster_roles counts them on the host: a CTA whose tile holds
//   no pair to compute (one past ni, or with `tri` every pair i >= j) still
//   runs its producer for a computing peer, while its consumers issue
//   nothing and store nothing; a cluster with no pair to compute exits at
//   once and leaves its outputs unwritten (with `tri` callers mask by i < j).
//   Every other thread ends on a cluster barrier, so that no CTA leaves
//   while its peer may still copy into it or arrive on its barriers.
// * The epilogue writes two neighbouring pairs' counters as one 8-byte store
//   (when nj is even), so a warp's stores fill whole sectors.
//
// What bounds it now (an H100 80GB HBM3 at 700 W): a 1024 x 1024 pair at
// 1,000,000 sites takes ~6.3 ms against the bound's 5.30 (one CTA a tile:
// 7.3 ms); the same kernel with no hand-over copy (not exact) read ~4.5%
// less, so the copy's issue and its shared-memory traffic, the coupling of
// the two CTAs' pipelines and the consumers' A build share what is left.
// The card's power is the next wall: the kernel draws ~690 W, and a hot
// card cuts its SM clock from 1,980 to ~1,830 MHz (sw_power_cap,
// sw_thermal_slowdown).

#include <cuda.h>  // CUtensorMap and its enums; the driver is reached through the runtime
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int kStageWords = 4;  // words per stage: a 16-byte slice of each row
constexpr uint32_t kByteOnes = 0x01010101u;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The three s8 indicator registers of one het/hom word pair for the K bytes
// that bits c, c+8, c+16, c+24 map to.
__device__ __forceinline__ void indicators(uint32_t het, uint32_t hom, int c,
                                           uint32_t& h, uint32_t& v, uint32_t& u) {
  const uint32_t e = het >> c, o = hom >> c;
  h = e & ~o & kByteOnes;
  v = ~e & kByteOnes;
  const uint32_t r = ~(e | o) & kByteOnes;  // hom-ref
  u = v + r * 0xFEu;
}

// The six counters of pair (i, j) from its five products, into out[k][i][j].
__device__ __forceinline__ void store_counters(int32_t* __restrict__ out, long long plane,
                                               long long at, uint32_t hh, uint32_t hv,
                                               uint32_t vh, uint32_t vv, uint32_t uu) {
  int32_t* o = out + at;
  o[0 * plane] = (int32_t)hh;
  o[1 * plane] = (int32_t)(hh + hv);
  o[2 * plane] = (int32_t)(hh + vh);
  o[3 * plane] = (int32_t)((vv - uu) >> 1);
  o[4 * plane] = (int32_t)((vv + uu) >> 1);
  o[5 * plane] = (int32_t)(hh + hv + vh + vv);
}

// store_counters for the neighbouring pairs (i, j) and (i, j + 1), each
// counter as one 8-byte store; `at` is even.
__device__ __forceinline__ void store_counter_pairs(int32_t* __restrict__ out, long long plane,
                                                    long long at, uint32_t hh0, uint32_t hh1,
                                                    uint32_t hv0, uint32_t hv1, uint32_t vh0,
                                                    uint32_t vh1, uint32_t vv0, uint32_t vv1,
                                                    uint32_t uu0, uint32_t uu1) {
  int2* o = reinterpret_cast<int2*>(out + at);
  const long long p = plane / 2;
  o[0 * p] = make_int2((int32_t)hh0, (int32_t)hh1);
  o[1 * p] = make_int2((int32_t)(hh0 + hv0), (int32_t)(hh1 + hv1));
  o[2 * p] = make_int2((int32_t)(hh0 + vh0), (int32_t)(hh1 + vh1));
  o[3 * p] = make_int2((int32_t)((vv0 - uu0) >> 1), (int32_t)((vv1 - uu1) >> 1));
  o[4 * p] = make_int2((int32_t)((vv0 + uu0) >> 1), (int32_t)((vv1 + uu1) >> 1));
  o[5 * p] = make_int2((int32_t)(hh0 + hv0 + vh0 + vv0), (int32_t)(hh1 + hv1 + vh1 + vv1));
}

// ---------------------------------------------------------------------------
// mbarriers and warpgroup registers.

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
// Arrives on `bar` and adds `bytes` to the copies its phase waits for.
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("{\n.reg .b64 state;\nmbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n"
               ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}
// One box of a 3-D tensor map (words, rows, planes) at (w, row, 0) into
// shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int w, int row,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(w), "r"(row), "r"(0), "r"(smem_addr(bar))
      : "memory");
}

// Waits for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------------
// The cluster: the other CTA's shared memory and the cluster barrier.

// The address of `p` (this CTA's shared memory) in the shared memory of the
// cluster's CTA `rank`, as the .shared::cluster instructions take it.
__device__ __forceinline__ uint32_t peer_addr(const void* p, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(smem_addr(p)), "r"(rank));
  return out;
}
// Arrives on a barrier of the cluster's other CTA (`bar` from peer_addr), with
// the default CTA-scope release: the arrival only says that this CTA's groups
// have retired their reads of a stage (the header says why not cluster scope).
__device__ __forceinline__ void mbar_arrive_peer(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Copies `bytes` of this CTA's shared memory into the other CTA's (`dst` from
// peer_addr), completing on its barrier `bar` (from peer_addr).
__device__ __forceinline__ void copy_to_peer(uint32_t dst, const void* src, uint32_t bytes,
                                             uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "r"(smem_addr(src)), "r"(bytes), "r"(bar)
      : "memory");
}
// Every thread of both CTAs: what each did before arrive is seen by all after
// wait.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void regs_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// wgmma.

// Shared-memory matrix descriptor: K-major, no swizzle, core matrices 8 rows
// x 16 bytes; `lbo` bytes to the next K half, `sbo` to the next 8 rows.
__device__ __forceinline__ uint64_t b_desc(const uint8_t* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(p) >> 4) & 0x3FFF) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// Keeps the compiler from moving accumulator accesses across a wgmma.
template <int N>
__device__ __forceinline__ void fence_operands(int (&d)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) asm volatile("" : "+r"(d[k])::"memory");
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_n64(int (&d)[32], const uint32_t (&a)[4],
                                          uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// ---------------------------------------------------------------------------
// The wgmma kernel (the main path).

constexpr int kWgBM = 128, kWgBN = 64;               // pair tile: i-rows x j-rows
constexpr int kCluster = 2;                          // CTAs along i sharing one j tile
constexpr int kWgBHalf = kWgBN / kCluster;           // j rows a CTA loads and unpacks
constexpr int kConsumers = 2;                        // warpgroups that issue, 64 i-rows each
constexpr int kWgThreads = 128 * (kConsumers + 1);   // and the producer warpgroup
constexpr int kPackedStages = 8;                     // packed-word ring
constexpr int kBStages = 4;                          // unpacked-B ring
constexpr int kLoadAhead = kPackedStages - kBStages; // stages loaded ahead of the unpack
constexpr int kASets = 3;                            // A register sets: groups in flight + 1
// setmaxnreg moves registers inside the CTA's pool, the 168 a thread has at
// launch (65,536 / 384, in steps of 8): 24 x 128 + 240 x 256 is all of it.
constexpr int kLaunchRegs = 65536 / kWgThreads / 8 * 8;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
static_assert(kProducerRegs * 128 + kConsumerRegs * 128 * kConsumers <= kLaunchRegs * kWgThreads,
              "more registers than the CTA's pool");
// B of one word is 16 slots of 384 bytes.  Slot n holds block n of the
// [H_j; v_j] operand (an 8-row core matrix pair, both K halves: 256 bytes)
// and, in its last 128 bytes, K half n % 2 of block n / 2 of u_j.  The
// [H_j; v_j] blocks run H of the half-rows 0-31, v of 0-31, H of 32-63, v of
// 32-63, so the 8 slots of a CTA's half hold all of its H, v and u rows: one
// contiguous run of 3 KB a word, which is what a producer warp hands over.
constexpr int kSlot = 384;
constexpr int kWgBWord = 16 * kSlot;                 // bytes of B per word
constexpr int kWgBStage = kStageWords * kWgBWord;    // per stage
constexpr int kWgBRun = kWgBWord / kCluster;         // a CTA's half of a word
static_assert(kWgBN == 64 && kCluster == 2, "the slot layout is for 64 j rows in halves of 32");
static_assert(kStageWords == 4, "a stage is one word for each producer warp");

// One stage of packed words: kStageWords words of each of the tile's i-rows
// and of this CTA's half of its j-rows, per plane, as the two tensor-map
// boxes land.
struct WgPacked {
  uint4 i[2][kWgBM];
  uint4 j[2][kWgBHalf];
};

struct WgShared {
  uint8_t b[kBStages][kWgBStage];  // first: descriptors need 16-byte alignment
  WgPacked packed[kPackedStages];
  uint64_t packed_full[kPackedStages];   // the stage's two boxes landed
  uint64_t packed_empty[kPackedStages];  // every warp has read the stage (12 warps)
  uint64_t b_full[kBStages];             // this CTA's half unpacked (4 producer warps), the
                                         // peer's half landed (their 4 copies' bytes)
  uint64_t b_empty[kBStages];            // both CTAs' groups that read the stage retired
};
constexpr int kWgSmem = (int)sizeof(WgShared);
static_assert(kWgSmem <= 227 * 1024, "over the shared memory a block can have");

// The producer warpgroup: loads every stage, unpacks its half of the j rows
// into B and hands that half to the cluster's other CTA.  A stage loads as
// two tensor-map boxes (4 words x 128 i-rows x 2 planes, 4 words x 32 j-rows
// x 2 planes), issued by one lane; rows past the storage read as zeros, rows
// past the panel as whatever the storage holds there, and no pair of either
// is stored.
__device__ __forceinline__ void wg_produce(WgShared& sm, const CUtensorMap* map_i,
                                           const CUtensorMap* map_j, int i_row0, int j_row0,
                                           int steps, int rank, int ptid) {
  auto load = [&](int s) {
    const int slot = s % kPackedStages;
    if (s >= kPackedStages) mbar_wait(&sm.packed_empty[slot], ((s / kPackedStages) - 1) & 1);
    mbar_arrive_expect(&sm.packed_full[slot], sizeof(WgPacked));
    tma_load(sm.packed[slot].i, map_i, s * kStageWords, i_row0, &sm.packed_full[slot]);
    tma_load(sm.packed[slot].j, map_j, s * kStageWords, j_row0, &sm.packed_full[slot]);
  };
  if (ptid == 0)
    for (int s = 0; s < steps && s < kLoadAhead; ++s) load(s);

  // Producer warp w unpacks word w of the CTA's 32 half-rows, lane l taking
  // half-row l (both K halves): each 8 lanes of a store write one 128-byte
  // run of a core matrix pair.  Its 3 KB of B then go to the peer's same
  // stage as one bulk copy, completing on the peer's "B full", with no
  // barrier across the warpgroup.
  const int lane = ptid % 32, w = ptid / 32;
  const int hv_off = w * kWgBWord + (8 * rank + lane / 8) * kSlot + (lane % 8) * 16;
  const int u_off = w * kWgBWord + 2 * (4 * rank + lane / 8) * kSlot + 256 + (lane % 8) * 16;
  for (int s = 0; s < steps; ++s) {
    const int slot = s % kPackedStages, bslot = s % kBStages;
    mbar_wait(&sm.packed_full[slot], (s / kPackedStages) & 1);
    // Both CTAs' groups have retired the stage: this CTA's half may be
    // overwritten here and in the peer.
    if (s >= kBStages) mbar_wait(&sm.b_empty[bslot], ((s / kBStages) - 1) & 1);
    const uint32_t het = reinterpret_cast<const uint32_t*>(&sm.packed[slot].j[0][lane])[w];
    const uint32_t hom = reinterpret_cast<const uint32_t*>(&sm.packed[slot].j[1][lane])[w];
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
      uint32_t h[4], v[4], u[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) indicators(het, hom, 4 * kh + c, h[c], v[c], u[c]);
      uint8_t* hv = sm.b[bslot] + hv_off + kh * 128;
      *reinterpret_cast<uint4*>(hv) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(hv + 4 * kSlot) = make_uint4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<uint4*>(sm.b[bslot] + u_off + kh * kSlot) =
          make_uint4(u[0], u[1], u[2], u[3]);
    }
    fence_proxy_async();  // the writes, to wgmma's and the bulk copy's async proxy
    __syncwarp();
    if (lane == 0) {
      const uint8_t* run = sm.b[bslot] + w * kWgBWord + rank * kWgBRun;
      const uint32_t peer = rank ^ 1;
      copy_to_peer(peer_addr(run, peer), run, kWgBRun, peer_addr(&sm.b_full[bslot], peer));
      // This CTA's "B full" also waits for the peer's copy of the word.
      mbar_arrive_expect(&sm.b_full[bslot], kWgBRun);
      mbar_arrive(&sm.packed_empty[slot]);
      // The loads go round the four warps, so that no warp carries a load
      // beside its copy on every stage (~6% of the kernel when warp 0 did).
      if (w == s % kStageWords && s + kLoadAhead < steps) load(s + kLoadAhead);
    }
  }
}

// The packed words of rows r0 and r1 (both planes) for words w and w + 1 of
// a stage: one 8-byte load each, eight rows of a warp in one wavefront.
struct APair {
  uint2 het0, hom0, het1, hom1;
};
__device__ __forceinline__ APair wg_load_a(const WgPacked& st, int r0, int r1, int w) {
  return {reinterpret_cast<const uint2*>(&st.i[0][r0])[w / 2],
          reinterpret_cast<const uint2*>(&st.i[1][r0])[w / 2],
          reinterpret_cast<const uint2*>(&st.i[0][r1])[w / 2],
          reinterpret_cast<const uint2*>(&st.i[1][r1])[w / 2]};
}

// A registers of one word, [H, v, u][fragment register], from its packed
// words of rows r0 (het0, hom0) and r1 = r0 + 8 (het1, hom1).
__device__ __forceinline__ void wg_build_a(uint32_t het0, uint32_t hom0, uint32_t het1,
                                           uint32_t hom1, int t, uint32_t (&a)[3][4]) {
  indicators(het0, hom0, t, a[0][0], a[1][0], a[2][0]);      // row g,   K lo
  indicators(het1, hom1, t, a[0][1], a[1][1], a[2][1]);      // row g+8, K lo
  indicators(het0, hom0, t + 4, a[0][2], a[1][2], a[2][2]);  // row g,   K hi
  indicators(het1, hom1, t + 4, a[0][3], a[1][3], a[2][3]);  // row g+8, K hi
}

// One group of three wgmmas for one word: H_i.[H_j; v_j], v_i.[H_j; v_j] and
// u_i.u_j, B of the word at `b`.
__device__ __forceinline__ void wg_issue(int (&acc_h)[64], int (&acc_v)[64],
                                         int (&acc_u)[32], const uint32_t (&a)[3][4],
                                         const uint8_t* b) {
  fence_operands(acc_h);
  fence_operands(acc_v);
  fence_operands(acc_u);
  wgmma_fence();
  wgmma_n128(acc_h, a[0], b_desc(b, 128, kSlot));
  wgmma_n128(acc_v, a[1], b_desc(b, 128, kSlot));
  wgmma_n64(acc_u, a[2], b_desc(b + 256, kSlot, 2 * kSlot));
  wgmma_commit();
  fence_operands(acc_h);
  fence_operands(acc_v);
  fence_operands(acc_u);
}

// A consumer warp's release of a B stage, to both CTAs' "B empty".
__device__ __forceinline__ void wg_release_b(WgShared& sm, int bslot, uint32_t peer) {
  mbar_arrive(&sm.b_empty[bslot]);
  mbar_arrive_peer(peer_addr(&sm.b_empty[bslot], peer));
}

// One stage of a consumer warpgroup: per word, build A into set
// (4 * k + w) % kASets, issue, and leave kASets - 1 groups in flight.
template <int k>
__device__ __forceinline__ void wg_consume_stage(WgShared& sm, int s, int r0, int r1, int t,
                                                 int lane, uint32_t peer, int (&acc_h)[64],
                                                 int (&acc_v)[64], int (&acc_u)[32],
                                                 uint32_t (&a)[kASets][3][4]) {
  const int slot = s % kPackedStages, bslot = s % kBStages;
  mbar_wait(&sm.packed_full[slot], (s / kPackedStages) & 1);
  const WgPacked& st = sm.packed[slot];
  APair p;
#pragma unroll
  for (int w = 0; w < kStageWords; ++w) {
    uint32_t(&x)[3][4] = a[(kStageWords * k + w) % kASets];
    if (w % 2 == 0) p = wg_load_a(st, r0, r1, w);
    if (w % 2 == 0)
      wg_build_a(p.het0.x, p.hom0.x, p.het1.x, p.hom1.x, t, x);
    else
      wg_build_a(p.het0.y, p.hom0.y, p.het1.y, p.hom1.y, t, x);
    if (w == kStageWords - 1) {  // this warp has read the stage
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.packed_empty[slot]);
    }
    if (w == 0) mbar_wait(&sm.b_full[bslot], (s / kBStages) & 1);
    wg_issue(acc_h, acc_v, acc_u, x, sm.b[bslot] + w * kWgBWord);
    wgmma_wait<kASets - 1>();
    // Once word 1's wait returns, the groups of the stage before have retired.
    if (w == 1 && s > 0 && lane == 0) wg_release_b(sm, (s - 1) % kBStages, peer);
  }
}

// A CTA of a 2-CTA cluster along i: CTA ranks 0 and 1 (blockIdx.y even and
// odd) share blockIdx.x and so the j tile.  Each loads and unpacks its half
// of the tile's B and hands it to the other; both multiply the whole of it.
// A CTA whose tile holds no pair to compute (one past ni, once the grid is
// rounded up to whole clusters, or, with `tri`, every pair i >= j) still
// runs its producer for its peer, its consumers issuing nothing; a cluster
// with no pair to compute exits at once.
__global__ void __cluster_dims__(1, kCluster, 1) __launch_bounds__(kWgThreads, 1)
king_counts_wgmma_kernel(const __grid_constant__ CUtensorMap map_i, long long i_off,
                         long long ni, const __grid_constant__ CUtensorMap map_j,
                         long long j_off, long long nj, long long words, int tri,
                         int32_t* __restrict__ out) {
  const long long i0 = (long long)blockIdx.y * kWgBM, j0 = (long long)blockIdx.x * kWgBN;
  const long long peer_i0 = (long long)(blockIdx.y ^ 1) * kWgBM;
  // The same rule as king_cuda.cluster_roles on the host.
  auto computes = [&](long long ti0) { return ti0 < ni && !(tri && ti0 >= j0 + kWgBN - 1); };
  const bool computing = computes(i0);
  if (!computing && !computes(peer_i0)) return;  // both CTAs of the cluster

  extern __shared__ __align__(128) uint8_t smem[];
  WgShared& sm = *reinterpret_cast<WgShared*>(smem);
  const int tid = threadIdx.x;
  const int rank = blockIdx.y & 1;
  const uint32_t peer = rank ^ 1;
  const int steps = (int)(words / kStageWords);
  if (tid == 0) {
    for (int k = 0; k < kPackedStages; ++k) {
      mbar_init(&sm.packed_full[k], 1);
      mbar_init(&sm.packed_empty[k], 4 * (kConsumers + 1));
    }
    for (int k = 0; k < kBStages; ++k) {
      mbar_init(&sm.b_full[k], 4);
      mbar_init(&sm.b_empty[k], 4 * kConsumers * kCluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // Both CTAs' barriers are initialised before either CTA touches the other's.
  cluster_arrive();
  cluster_wait();

  const int wg = tid / 128;
  if (wg == kConsumers) {
    regs_dealloc<kProducerRegs>();
    // A helper loads its peer's i rows (which lie inside the storage) and
    // reads none of them.
    wg_produce(sm, &map_i, &map_j, (int)(i_off + (computing ? i0 : peer_i0)),
               (int)(j_off + j0 + kWgBHalf * rank), steps, rank, tid - 128 * kConsumers);
    cluster_arrive();
    cluster_wait();
    return;
  }
  regs_alloc<kConsumerRegs>();
  const int lane = tid & 31;
  if (!computing) {
    // A helper's consumers keep the hand-overs of both CTAs in step: each
    // stage is read (nothing) and released as the computing peer's are.
    for (int s = 0; s < steps; ++s) {
      const int slot = s % kPackedStages, bslot = s % kBStages;
      mbar_wait(&sm.packed_full[slot], (s / kPackedStages) & 1);
      __syncwarp();
      if (lane == 0) mbar_arrive(&sm.packed_empty[slot]);
      mbar_wait(&sm.b_full[bslot], (s / kBStages) & 1);
      __syncwarp();
      if (lane == 0) wg_release_b(sm, bslot, peer);
    }
    cluster_arrive();
    cluster_wait();
    return;
  }
  const int q = (tid >> 5) & 3;                   // warp within the warpgroup
  const int g = lane >> 2, t = lane & 3;          // fragment row group, thread in quad
  const int r0 = 64 * wg + 16 * q + g, r1 = r0 + 8;
  int acc_h[64] = {}, acc_v[64] = {}, acc_u[32] = {};  // HH|Hv, vH|vv, uu
  uint32_t a[kASets][3][4];
  // kASets stages per trip, so that each word's register set is fixed.
  static_assert(kASets == 3, "one call per stage of a trip");
  for (int s = 0; s < steps; s += kASets) {
    wg_consume_stage<0>(sm, s, r0, r1, t, lane, peer, acc_h, acc_v, acc_u, a);
    if (s + 1 < steps)
      wg_consume_stage<1>(sm, s + 1, r0, r1, t, lane, peer, acc_h, acc_v, acc_u, a);
    if (s + 2 < steps)
      wg_consume_stage<2>(sm, s + 2, r0, r1, t, lane, peer, acc_h, acc_v, acc_u, a);
  }
  wgmma_wait<0>();
  fence_operands(acc_h);
  fence_operands(acc_v);
  fence_operands(acc_u);
  // Nothing of either CTA's shared memory is touched after this: the peer
  // may leave once the epilogue's stores are issued.
  cluster_arrive();

  // Accumulator layout: entry 4n + e is row g + 8 * (e / 2), column
  // 8n + 2t + e % 2, column group n reading B's block n.  In acc_h / acc_v,
  // j rows 8b..8b+7 are group hb = (b / 4) * 8 + b % 4 against H_j and hb + 4
  // against v_j (the slot order); in acc_u they are group b.  Entries e and
  // e + 1 are neighbours in a row: with nj even they go out as one 8-byte
  // store, so a warp's store fills whole 32-byte sectors.
  const long long plane = ni * nj;
#pragma unroll
  for (int nb = 0; nb < kWgBN / 8; ++nb) {
    const int hb = (nb / 4) * 8 + nb % 4, vb = hb + 4;
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const long long i = i0 + (e < 2 ? r0 : r1);
      const long long j = j0 + nb * 8 + 2 * t;
      if (i >= ni || j >= nj) continue;
      if (nj % 2 == 0) {
        store_counter_pairs(out, plane, i * nj + j, acc_h[4 * hb + e], acc_h[4 * hb + e + 1],
                            acc_h[4 * vb + e], acc_h[4 * vb + e + 1], acc_v[4 * hb + e],
                            acc_v[4 * hb + e + 1], acc_v[4 * vb + e], acc_v[4 * vb + e + 1],
                            acc_u[4 * nb + e], acc_u[4 * nb + e + 1]);
        continue;
      }
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        if (j + d >= nj) continue;
        store_counters(out, plane, i * nj + j + d, acc_h[4 * hb + e + d],
                       acc_h[4 * vb + e + d], acc_v[4 * hb + e + d], acc_v[4 * vb + e + d],
                       acc_u[4 * nb + e + d]);
      }
    }
  }
  cluster_wait();
}

// ---------------------------------------------------------------------------
// Tensor maps of the planes, encoded once per (storage, box) and kept.

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

struct MapEntry {
  const void* planes;
  long long rows, words;
  int box_rows;
  CUtensorMap map;
};
constexpr int kMapCache = 16;
MapEntry g_maps[kMapCache];
int g_maps_used = 0, g_maps_next = 0;
std::mutex g_maps_mutex;

// The map of planes [2, rows, words] (uint32) with boxes of 4 words x
// box_rows rows x 2 planes; false when the driver refuses it.
bool plane_map(const void* planes, long long rows, long long words, int box_rows,
               CUtensorMap* map) {
  std::lock_guard<std::mutex> lock(g_maps_mutex);
  for (int k = 0; k < g_maps_used; ++k) {
    const MapEntry& e = g_maps[k];
    if (e.planes == planes && e.rows == rows && e.words == words && e.box_rows == box_rows) {
      *map = e.map;
      return true;
    }
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)words, (cuuint64_t)rows, 2};
  const cuuint64_t strides[2] = {(cuuint64_t)words * 4, (cuuint64_t)(rows * words) * 4};
  const cuuint32_t box[3] = {kStageWords, (cuuint32_t)box_rows, 2};
  const cuuint32_t steps[3] = {1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 3, const_cast<void*>(planes), dims, strides,
             box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  g_maps[g_maps_next] = {planes, rows, words, box_rows, *map};
  g_maps_next = (g_maps_next + 1) % kMapCache;
  if (g_maps_used < kMapCache) ++g_maps_used;
  return true;
}

}  // namespace

extern "C" {

// Six [ni, nj] int32 counter planes into `out` ([6, ni, nj], contiguous) for
// rows [i_off, i_off + ni) of planes_i ([2, rows_i, words]) against rows
// [j_off, j_off + nj) of planes_j ([2, rows_j, words]).  The caller checks
// bounds, 16-byte alignment and words % 4 == 0.  Launches on `stream`, does
// not synchronise, and returns the CUDA error of the launch (0 on success).
int king_counts_launch(const void* planes_i, long long rows_i, long long i_off,
                       long long ni, const void* planes_j, long long rows_j,
                       long long j_off, long long nj, long long words, int tri,
                       void* out, void* stream) {
  // The opt-in to more than 48 KiB of dynamic shared memory belongs to the
  // current device's context, so it is set on every launch: a process may
  // launch on several devices, from several threads.
  const cudaError_t err = cudaFuncSetAttribute(
      king_counts_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Tensor-map coordinates are 32-bit.
  if (rows_i >= (1ll << 31) || rows_j >= (1ll << 31) || words >= (1ll << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map_i{}, map_j{};  // with no words, no stage loads and the counters are 0
  if (words > 0 && (!plane_map(planes_i, rows_i, words, kWgBM, &map_i) ||
                    !plane_map(planes_j, rows_j, words, kWgBHalf, &map_j)))
    return static_cast<int>(cudaErrorInvalidValue);
  // The i tiles rounded up to whole clusters.
  const long long tiles_i = (ni + kWgBM - 1) / kWgBM;
  const dim3 grid((unsigned)((nj + kWgBN - 1) / kWgBN),
                  (unsigned)((tiles_i + kCluster - 1) / kCluster * kCluster));
  king_counts_wgmma_kernel<<<grid, kWgThreads, kWgSmem, static_cast<cudaStream_t>(stream)>>>(
      map_i, i_off, ni, map_j, j_off, nj, words, tri, static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
