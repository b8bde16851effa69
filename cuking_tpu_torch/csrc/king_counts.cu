// KING counters for one (i-panel, j-panel) pair: AND + popcount over packed
// het/hom words, on Hopper (sm_90a).
//
// Replaces: cuking_tpu/ops/king_pallas.py `_king_body`, reached through
// `panel_counts_pallas` (sliced panels) and `_panel_counts_pallas_indexed`
// (row offsets into the full storage).  Both entries of the port
// (cuking_tpu_torch/ops/king_cuda.py) launch this one kernel with a base
// pointer and a row offset per side.
//
// What it computes.  Planes are [2, rows, W] 32-bit words (plane 0 = het,
// plane 1 = hom; (1,1) = missing).  Per word the kernel derives
//   h = het & ~hom   a = ~het & hom   r = ~het & ~hom   d = ~(het & hom)
// and for every pair (i, j) accumulates
//   both_het   += popc(h_i & h_j)      het_i  += popc(h_i & d_j)
//   het_j      += popc(d_i & h_j)      shared += popc(d_i & d_j)
//   opposing   += popc((r_i & a_j) | (a_i & r_j))
//   concordant += popc((r_i & r_j) | (a_i & a_j))
// which equal the TPU kernel's Gram-block expressions (king_mm.py algebra).
// Words past W and rows past the panel are staged as missing, so they add 0.
//
// Shape.  One CTA owns a 64 x 64 pair tile and loops over ALL W words: the
// TPU's sequential site-chunk grid axis carried its Gram in VMEM scratch,
// and no CUDA block can carry state to another, so the loop replaces that
// axis.  Each 16-word site chunk of the tile's 64 i-rows and 64 j-rows is
// loaded with one 16-byte load per thread per plane, split into h/a/r/d and
// staged in shared memory (32 KiB).  Each of the 256 threads keeps a 4 x 4
// register sub-tile of pairs x 6 counters.  With `tri` set (a diagonal panel
// pair), CTAs wholly below the tile diagonal exit at once and leave their
// outputs unwritten; callers mask by global i < j.
//
// What bounds it on this card: integer issue, not memory.  Per pair and
// word it issues 6 POPC (16 results per clock per SM on sm_90, a quarter of
// the LOP3/IADD rate) plus ~16 logic/add ops, with both operands read from
// shared memory.  Every staged word serves 64 pairs, so the CTA loads a
// quarter of a byte per pair-word from L2/device memory.
//
// Later work: the int8 tensor-core form (mma/wgmma over unpacked H/A/D
// indicators, ROADMAP queue 2) and `mma.sync` b1 AND+POPC are later PRs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;                 // pair-tile edge (TI = TJ)
constexpr int kThreadsPerEdge = 16;       // blockDim = 16 x 16
constexpr int kSub = kTile / kThreadsPerEdge;  // 4 x 4 pairs per thread
constexpr int kChunk = 16;                // words staged per step (64 bytes/row)
constexpr int kKinds = 4;                 // h, a, r, d

struct Staged {
  uint32_t k[kKinds][kChunk][kTile];
};

// Loads one 16-byte quarter of a row's site chunk and stores its derived
// words.  Out-of-range rows or words stage as missing (all four kinds 0).
__device__ __forceinline__ void stage_quarter(
    Staged& s, const uint32_t* __restrict__ planes, long long rows,
    long long row0, long long n, long long words, long long w0, int tid) {
  const int row = tid >> 2;            // 0..63
  const int q = tid & 3;               // which 4-word quarter of the chunk
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

__global__ void __launch_bounds__(kThreadsPerEdge * kThreadsPerEdge)
king_counts_kernel(const uint32_t* __restrict__ planes_i, long long rows_i,
                   long long i_off, long long ni,
                   const uint32_t* __restrict__ planes_j, long long rows_j,
                   long long j_off, long long nj, long long words, int tri,
                   int32_t* __restrict__ out) {
  const int bi = blockIdx.y, bj = blockIdx.x;
  if (tri && bi > bj) return;  // wholly below the tile diagonal: all i > j

  __shared__ Staged si, sj;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kThreadsPerEdge + tx;
  const long long i0 = (long long)bi * kTile, j0 = (long long)bj * kTile;

  int bh[kSub][kSub] = {}, hi[kSub][kSub] = {}, hj[kSub][kSub] = {};
  int oh[kSub][kSub] = {}, ch[kSub][kSub] = {}, ss[kSub][kSub] = {};

  for (long long w0 = 0; w0 < words; w0 += kChunk) {
    __syncthreads();  // the previous chunk is fully consumed
    stage_quarter(si, planes_i, rows_i, i_off + i0, ni - i0, words, w0, tid);
    stage_quarter(sj, planes_j, rows_j, j_off + j0, nj - j0, words, w0, tid);
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < kChunk; ++c) {
      uint32_t jh[kSub], ja[kSub], jr[kSub], jd[kSub];
#pragma unroll
      for (int b = 0; b < kSub; ++b) {
        const int col = tx + kThreadsPerEdge * b;
        jh[b] = sj.k[0][c][col];
        ja[b] = sj.k[1][c][col];
        jr[b] = sj.k[2][c][col];
        jd[b] = sj.k[3][c][col];
      }
#pragma unroll
      for (int a = 0; a < kSub; ++a) {
        const int row = ty + kThreadsPerEdge * a;
        const uint32_t ih = si.k[0][c][row], ia = si.k[1][c][row];
        const uint32_t ir = si.k[2][c][row], id = si.k[3][c][row];
#pragma unroll
        for (int b = 0; b < kSub; ++b) {
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
  for (int a = 0; a < kSub; ++a) {
    const long long i = i0 + ty + kThreadsPerEdge * a;
    if (i >= ni) continue;
#pragma unroll
    for (int b = 0; b < kSub; ++b) {
      const long long j = j0 + tx + kThreadsPerEdge * b;
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
// not synchronise, and returns cudaGetLastError().
int king_counts_launch(const void* planes_i, long long rows_i, long long i_off,
                       long long ni, const void* planes_j, long long rows_j,
                       long long j_off, long long nj, long long words, int tri,
                       void* out, void* stream) {
  const dim3 grid((unsigned)((nj + kTile - 1) / kTile),
                  (unsigned)((ni + kTile - 1) / kTile));
  const dim3 block(kThreadsPerEdge, kThreadsPerEdge);
  king_counts_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(planes_i), rows_i, i_off, ni,
      static_cast<const uint32_t*>(planes_j), rows_j, j_off, nj, words, tri,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
