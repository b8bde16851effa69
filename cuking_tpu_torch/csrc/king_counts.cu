// KING counters for one (i-panel, j-panel) pair on Hopper (sm_90a): an int8
// tensor-core (wgmma) kernel that unpacks the packed het/hom words on chip.
//
// Replaces: cuking_tpu/ops/king_pallas.py `_king_body`, reached through
// `panel_counts_pallas` (sliced panels) and `_panel_counts_pallas_indexed`
// (row offsets into the full storage).  Both entries of the port
// (cuking_tpu_torch/ops/king_cuda.py) call `king_counts_launch` with a base
// pointer and a row offset per side.
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
// 25 MB of counters out take 0.023 ms at 3.35 TB/s.  So tensor-core
// operations bound it, and the design keeps the rest (the unpack, the
// loads, the barriers) off the tensor cores' way:
//
// * The unpacked indicators never touch device memory.  A k32 step is one
//   32-bit word.  K bytes 4c..4c+3 of a word come from bits c, c+8, c+16,
//   c+24 (c = 0..7; any bijection works, since only the Gram matters), so
//   one indicator register is `(word >> c) & 0x01010101`, and
//   u = v + R * 0xFE is 1 for hom-alt and 0xFF for hom-ref with no byte
//   carries: six integer operations give the H, v and u registers of one c.
// * A (the i side) is built in registers: in the k32 s8 fragment, thread t
//   of a quad holds K bytes 4t..4t+3 and 16+4t..16+4t+3, i.e. c = t and
//   c = t + 4 of rows g and g + 8.  B (the j side) is unpacked once per CTA
//   into shared memory as K-major core matrices (8 rows x 16 bytes, no
//   swizzle): [word][H, v, u][8-row block][K half][row].
// * A CTA is two warpgroups over a 128 x 64 pair tile (64 i-rows each), so
//   a 1024 x 1024 launch is 128 CTAs: one wave on 132 SMs at one CTA per
//   SM.  Per word a warpgroup issues m64n128k32 of H_i against [H_j; v_j]
//   (HH | Hv), the same for v_i (vH | vv) and m64n64k32 of u_i against u_j:
//   160 accumulator registers per thread.
// * Packed words arrive through a 4-stage `cp.async` ring of 4-word
//   (16-byte) row slices, so W need only be a multiple of 4 and no K tail
//   exists; rows past the panel read a valid row and their pairs are never
//   stored.  Each stage is issued as two wgmma groups of two words with their
//   own A registers, so one group is always queued while the threads build
//   the next group's A and unpack the next stage's B (triple-buffered), with
//   one CTA barrier per stage.
// * With `tri` set (a diagonal panel pair), CTAs whose every pair has i >= j
//   exit at once and leave their outputs unwritten; callers mask by i < j.
//
// `king_counts_popc_launch` keeps the same contract through the first port's
// AND + popcount kernel: the yardstick the wgmma kernel is timed against.
// Nothing on the main path calls it.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStageWords = 4;  // words per staged row slice: one 16-byte copy
constexpr uint32_t kByteOnes = 0x01010101u;

// One stage of packed words: kStageWords words of each of BM i-rows and BN
// j-rows, per plane.
template <int BM, int BN>
struct Packed {
  uint4 i[2][BM];
  uint4 j[2][BN];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Copies words [w0, w0 + 4) of the CTA's BM i-rows and BN j-rows, both
// planes, into one stage.  A row past the panel copies the panel's last row.
template <int BM, int BN, int kThreads>
__device__ __forceinline__ void load_stage(
    Packed<BM, BN>& s, const uint32_t* __restrict__ planes_i, long long rows_i,
    long long i_row0, long long i_left, const uint32_t* __restrict__ planes_j,
    long long rows_j, long long j_row0, long long j_left, long long words,
    long long w0, int tid) {
  constexpr int kCopies = 2 * (BM + BN);
#pragma unroll
  for (int c = tid; c < kCopies; c += kThreads) {
    const bool side_i = c < 2 * BM;
    const int cc = side_i ? c : c - 2 * BM;
    const int n = side_i ? BM : BN;
    const int plane = cc / n, row = cc % n;
    const long long left = side_i ? i_left : j_left;
    const long long r = (side_i ? i_row0 : j_row0) + (row < left ? row : left - 1);
    const uint32_t* src =
        (side_i ? planes_i : planes_j) + (plane * (side_i ? rows_i : rows_j) + r) * words + w0;
    cp_async16(side_i ? &s.i[plane][row] : &s.j[plane][row], src);
  }
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

// ---------------------------------------------------------------------------
// The wgmma kernel (the main path).

constexpr int kWgBM = 128, kWgBN = 64;
constexpr int kWgThreads = 256;                      // two warpgroups
constexpr int kWgStages = 4;                         // packed-word ring
constexpr int kWgBBufs = 3;                          // unpacked-B buffers
constexpr int kWgBWord = 3 * kWgBN * 32;             // bytes of B per word
constexpr int kWgBStage = kStageWords * kWgBWord;    // per stage
using WgPacked = Packed<kWgBM, kWgBN>;
constexpr int kWgSmem = kWgStages * (int)sizeof(WgPacked) + kWgBBufs * kWgBStage;

// Unpacks words [2 * half, 2 * half + 2) of the j rows of one packed stage
// into B's core-matrix layout: one (row, K half, word) task per thread.
__device__ __forceinline__ void wg_unpack_b(uint8_t* b, const WgPacked& s, int half,
                                            int tid) {
  static_assert(2 * 2 * kWgBN == kWgThreads, "one task per thread per half");
  const int task = tid + half * kWgThreads;
  const int row = task % kWgBN, kh = (task / kWgBN) % 2, w = task / (2 * kWgBN);
  const uint32_t het = reinterpret_cast<const uint32_t*>(&s.j[0][row])[w];
  const uint32_t hom = reinterpret_cast<const uint32_t*>(&s.j[1][row])[w];
  uint32_t h[4], v[4], u[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) indicators(het, hom, 4 * kh + c, h[c], v[c], u[c]);
  uint8_t* base = b + w * kWgBWord + (row / 8) * 256 + kh * 128 + (row % 8) * 16;
  *reinterpret_cast<uint4*>(base) = make_uint4(h[0], h[1], h[2], h[3]);
  *reinterpret_cast<uint4*>(base + 2048) = make_uint4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<uint4*>(base + 4096) = make_uint4(u[0], u[1], u[2], u[3]);
}

// Shared-memory matrix descriptor: K-major, no swizzle, core matrices 8 rows
// x 16 bytes; LBO 128 bytes (next K half), SBO 256 bytes (next 8 rows).
__device__ __forceinline__ uint64_t b_desc(const uint8_t* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a >> 4) & 0x3FFF) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
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


// A registers (H, v, u) of rows r0 and r1 for words w0 and w0 + 1 of a stage.
__device__ __forceinline__ void wg_build_a(const WgPacked& st, int r0, int r1, int t,
                                           int w0, uint32_t (&h)[2][4],
                                           uint32_t (&v)[2][4], uint32_t (&u)[2][4]) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int w = w0 + k;
    const uint32_t het0 = reinterpret_cast<const uint32_t*>(&st.i[0][r0])[w];
    const uint32_t hom0 = reinterpret_cast<const uint32_t*>(&st.i[1][r0])[w];
    const uint32_t het1 = reinterpret_cast<const uint32_t*>(&st.i[0][r1])[w];
    const uint32_t hom1 = reinterpret_cast<const uint32_t*>(&st.i[1][r1])[w];
    indicators(het0, hom0, t, h[k][0], v[k][0], u[k][0]);      // row g,   K lo
    indicators(het1, hom1, t, h[k][1], v[k][1], u[k][1]);      // row g+8, K lo
    indicators(het0, hom0, t + 4, h[k][2], v[k][2], u[k][2]);  // row g,   K hi
    indicators(het1, hom1, t + 4, h[k][3], v[k][3], u[k][3]);  // row g+8, K hi
  }
}

// One group of six wgmmas: two words x (H_i.[H_j; v_j], v_i.[H_j; v_j],
// u_i.u_j), B of the first word at `b`.
__device__ __forceinline__ void wg_issue(int (&acc_h)[64], int (&acc_v)[64],
                                         int (&acc_u)[32], const uint32_t (&h)[2][4],
                                         const uint32_t (&v)[2][4],
                                         const uint32_t (&u)[2][4], const uint8_t* b) {
  fence_operands(acc_h);
  fence_operands(acc_v);
  fence_operands(acc_u);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint8_t* bw = b + k * kWgBWord;
    wgmma_n128(acc_h, h[k], b_desc(bw));
    wgmma_n128(acc_v, v[k], b_desc(bw));
    wgmma_n64(acc_u, u[k], b_desc(bw + 4096));
  }
  wgmma_commit();
  fence_operands(acc_h);
  fence_operands(acc_v);
  fence_operands(acc_u);
}

__global__ void __launch_bounds__(kWgThreads, 1)
king_counts_wgmma_kernel(const uint32_t* __restrict__ planes_i, long long rows_i,
                         long long i_off, long long ni,
                         const uint32_t* __restrict__ planes_j, long long rows_j,
                         long long j_off, long long nj, long long words, int tri,
                         int32_t* __restrict__ out) {
  const long long i0 = (long long)blockIdx.y * kWgBM, j0 = (long long)blockIdx.x * kWgBN;
  if (tri && i0 >= j0 + kWgBN - 1) return;  // every pair of the tile has i >= j

  extern __shared__ __align__(128) uint8_t smem[];
  WgPacked* raw = reinterpret_cast<WgPacked*>(smem);
  uint8_t* bbuf = smem + kWgStages * sizeof(WgPacked);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // fragment row group, thread in quad
  const int wg = warp / 4, q = warp % 4;  // warpgroup, warp within it

  const long long i_row0 = i_off + i0, i_left = ni - i0;
  const long long j_row0 = j_off + j0, j_left = nj - j0;
  const int steps = (int)(words / kStageWords);
  auto load = [&](int s) {
    load_stage<kWgBM, kWgBN, kWgThreads>(raw[s % kWgStages], planes_i, rows_i, i_row0,
                                         i_left, planes_j, rows_j, j_row0, j_left,
                                         words, (long long)s * kStageWords, tid);
  };

#pragma unroll
  for (int s = 0; s < kWgStages - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }
  cp_async_wait<kWgStages - 2>();
  __syncthreads();
  wg_unpack_b(bbuf, raw[0], 0, tid);
  wg_unpack_b(bbuf, raw[0], 1, tid);
  fence_proxy_async();

  int acc_h[64] = {}, acc_v[64] = {}, acc_u[32] = {};  // HH|Hv, vH|vv, uu
  const int r0 = 64 * wg + 16 * q + g, r1 = r0 + 8;

  // Stage s reads B buffer s % 3 while stage s - 1 may still read its own
  // and stage s + 1 is unpacked into the third, half after each group.
  for (int step = 0; step < steps; ++step) {
    const bool more = step + 1 < steps;
    const WgPacked& st = raw[step % kWgStages];
    const WgPacked& st_next = raw[(step + 1) % kWgStages];
    const uint8_t* b = bbuf + (step % kWgBBufs) * kWgBStage;
    uint8_t* b_next = bbuf + ((step + 1) % kWgBBufs) * kWgBStage;
    uint32_t xh[2][4], xv[2][4], xu[2][4], yh[2][4], yv[2][4], yu[2][4];
    cp_async_wait<kWgStages - 3>();  // this thread's copies of stage step + 1
    wg_build_a(st, r0, r1, t, 0, xh, xv, xu);
    // B of this stage and the packed words of the next are visible to all;
    // every warpgroup retired the stage before last (whose B buffer the next
    // unpack reuses) and built its A from the previous packed stage (whose
    // slot the next load reuses).
    __syncthreads();
    if (step + kWgStages - 1 < steps) load(step + kWgStages - 1);
    cp_async_commit();
    wg_issue(acc_h, acc_v, acc_u, xh, xv, xu, b);
    if (more) wg_unpack_b(b_next, st_next, 0, tid);
    wgmma_wait<1>();  // the previous stage's words 2-3 are retired
    wg_build_a(st, r0, r1, t, 2, yh, yv, yu);
    wg_issue(acc_h, acc_v, acc_u, yh, yv, yu, b + 2 * kWgBWord);
    if (more) {
      wg_unpack_b(b_next, st_next, 1, tid);
      fence_proxy_async();
    }
    wgmma_wait<1>();  // words 0-1 are retired
  }
  wgmma_wait<0>();
  fence_operands(acc_h);
  fence_operands(acc_v);
  fence_operands(acc_u);

  // Accumulator layout: entry 4n + e is row g + 8 * (e / 2), column
  // 8n + 2t + e % 2; columns 64-127 of acc_h / acc_v hold Hv / vv.
  const long long plane = ni * nj;
#pragma unroll
  for (int nb = 0; nb < kWgBN / 8; ++nb) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long i = i0 + (e < 2 ? r0 : r1);
      const long long j = j0 + nb * 8 + 2 * t + (e & 1);
      if (i >= ni || j >= nj) continue;
      store_counters(out, plane, i * nj + j, acc_h[4 * nb + e], acc_h[4 * (nb + 8) + e],
                     acc_v[4 * nb + e], acc_v[4 * (nb + 8) + e], acc_u[4 * nb + e]);
    }
  }
}

// ---------------------------------------------------------------------------
// The AND + popcount kernel (the first port's design).
//
// Per word it derives h = het & ~hom, a = ~het & hom, r = ~het & ~hom,
// d = ~(het & hom) and accumulates, for every pair,
//   both_het += popc(h_i & h_j)   het_i += popc(h_i & d_j)
//   het_j += popc(d_i & h_j)      shared += popc(d_i & d_j)
//   opposing += popc((r_i & a_j) | (a_i & r_j))
//   concordant += popc((r_i & r_j) | (a_i & a_j))
// One CTA owns a 64 x 64 pair tile; 16-word site chunks are staged split
// into h/a/r/d, and each of 256 threads keeps a 4 x 4 sub-tile of pairs x 6
// counters.  Bounded by integer issue: 6 POPC per pair and word, at 16 per
// clock per SM.  Words past W and rows past the panel stage as missing.

constexpr int kPopcTile = 64;
constexpr int kPopcEdge = 16;                    // blockDim = 16 x 16
constexpr int kPopcSub = kPopcTile / kPopcEdge;  // 4 x 4 pairs per thread
constexpr int kPopcChunk = 16;                   // words staged per step

struct PopcStaged {
  uint32_t k[4][kPopcChunk][kPopcTile];  // h, a, r, d
};

__device__ __forceinline__ void popc_stage_quarter(
    PopcStaged& s, const uint32_t* __restrict__ planes, long long rows,
    long long row0, long long n, long long words, long long w0, int tid) {
  const int row = tid >> 2;
  const int q = tid & 3;
  const long long w = w0 + 4 * q;
  uint4 het = make_uint4(~0u, ~0u, ~0u, ~0u);
  uint4 hom = het;
  if (row < n && w < words) {
    const long long base = (row0 + row) * words + w;
    het = *reinterpret_cast<const uint4*>(planes + base);
    hom = *reinterpret_cast<const uint4*>(planes + rows * words + base);
  }
  const uint32_t he[4] = {het.x, het.y, het.z, het.w};
  const uint32_t ho[4] = {hom.x, hom.y, hom.z, hom.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int c = 4 * q + e;
    s.k[0][c][row] = he[e] & ~ho[e];
    s.k[1][c][row] = ~he[e] & ho[e];
    s.k[2][c][row] = ~he[e] & ~ho[e];
    s.k[3][c][row] = ~(he[e] & ho[e]);
  }
}

__global__ void __launch_bounds__(kPopcEdge * kPopcEdge)
king_counts_popc_kernel(const uint32_t* __restrict__ planes_i, long long rows_i,
                        long long i_off, long long ni,
                        const uint32_t* __restrict__ planes_j, long long rows_j,
                        long long j_off, long long nj, long long words, int tri,
                        int32_t* __restrict__ out) {
  const int bi = blockIdx.y, bj = blockIdx.x;
  if (tri && bi > bj) return;  // wholly below the tile diagonal: all i > j

  __shared__ PopcStaged si, sj;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kPopcEdge + tx;
  const long long i0 = (long long)bi * kPopcTile, j0 = (long long)bj * kPopcTile;

  int bh[kPopcSub][kPopcSub] = {}, hi[kPopcSub][kPopcSub] = {};
  int hj[kPopcSub][kPopcSub] = {}, oh[kPopcSub][kPopcSub] = {};
  int ch[kPopcSub][kPopcSub] = {}, ss[kPopcSub][kPopcSub] = {};

  for (long long w0 = 0; w0 < words; w0 += kPopcChunk) {
    __syncthreads();
    popc_stage_quarter(si, planes_i, rows_i, i_off + i0, ni - i0, words, w0, tid);
    popc_stage_quarter(sj, planes_j, rows_j, j_off + j0, nj - j0, words, w0, tid);
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < kPopcChunk; ++c) {
      uint32_t jh[kPopcSub], ja[kPopcSub], jr[kPopcSub], jd[kPopcSub];
#pragma unroll
      for (int b = 0; b < kPopcSub; ++b) {
        const int col = tx + kPopcEdge * b;
        jh[b] = sj.k[0][c][col];
        ja[b] = sj.k[1][c][col];
        jr[b] = sj.k[2][c][col];
        jd[b] = sj.k[3][c][col];
      }
#pragma unroll
      for (int a = 0; a < kPopcSub; ++a) {
        const int row = ty + kPopcEdge * a;
        const uint32_t ih = si.k[0][c][row], ia = si.k[1][c][row];
        const uint32_t ir = si.k[2][c][row], id = si.k[3][c][row];
#pragma unroll
        for (int b = 0; b < kPopcSub; ++b) {
          bh[a][b] += __popc(ih & jh[b]);
          hi[a][b] += __popc(ih & jd[b]);
          hj[a][b] += __popc(id & jh[b]);
          ss[a][b] += __popc(id & jd[b]);
          oh[a][b] += __popc((ir & ja[b]) | (ia & jr[b]));
          ch[a][b] += __popc((ir & jr[b]) | (ia & ja[b]));
        }
      }
    }
  }

  const long long plane = ni * nj;
#pragma unroll
  for (int a = 0; a < kPopcSub; ++a) {
    const long long i = i0 + ty + kPopcEdge * a;
    if (i >= ni) continue;
#pragma unroll
    for (int b = 0; b < kPopcSub; ++b) {
      const long long j = j0 + tx + kPopcEdge * b;
      if (j >= nj) continue;
      int32_t* o = out + i * nj + j;
      o[0 * plane] = bh[a][b];
      o[1 * plane] = hi[a][b];
      o[2 * plane] = hj[a][b];
      o[3 * plane] = oh[a][b];
      o[4 * plane] = ch[a][b];
      o[5 * plane] = ss[a][b];
    }
  }
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
  const dim3 grid((unsigned)((nj + kWgBN - 1) / kWgBN), (unsigned)((ni + kWgBM - 1) / kWgBM));
  king_counts_wgmma_kernel<<<grid, kWgThreads, kWgSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(planes_i), rows_i, i_off, ni,
      static_cast<const uint32_t*>(planes_j), rows_j, j_off, nj, words, tri,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The same contract, through the AND + popcount kernel.
int king_counts_popc_launch(const void* planes_i, long long rows_i, long long i_off,
                            long long ni, const void* planes_j, long long rows_j,
                            long long j_off, long long nj, long long words,
                            int tri, void* out, void* stream) {
  const dim3 grid((unsigned)((nj + kPopcTile - 1) / kPopcTile),
                  (unsigned)((ni + kPopcTile - 1) / kPopcTile));
  const dim3 block(kPopcEdge, kPopcEdge);
  king_counts_popc_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(planes_i), rows_i, i_off, ni,
      static_cast<const uint32_t*>(planes_j), rows_j, j_off, nj, words, tri,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
