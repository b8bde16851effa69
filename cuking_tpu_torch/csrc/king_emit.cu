// The emit step of one panel pair on Hopper (sm_90a): six KING counters in,
// thresholded hits out, appended to one device-resident result buffer.
//
// Replaces: the JAX sweep's per-step epilogue, mask and compaction, which
// XLA fused around the Pallas count kernel: `king_from_counts`
// (cuking_tpu/ops/king_math.py), the strict i < j and kin > threshold mask
// (cuking_tpu/models/king.py `_pair_compute`) and `accumulate_hits`
// (cuking_tpu/ops/compaction.py).  Its model is the reference's: one
// preallocated result array and a global atomic slot counter
// (cuking.cu:296-313).  The port calls `king_emit_launch` from
// cuking_tpu_torch/ops/king_emit.py after every count launch of the engine
// and of every ring sub-tile.
//
// What it computes.  One thread per pair (li, lj) of the [6, ni, nj] int32
// counters (both_het, het_i, het_j, opposing_hom, concordant_hom, shared).
// With global indices gi = gi_base + li and gj = gj_base + lj, the pair is a
// candidate when gi < i_limit, gj < j_limit and, with `strict`, gi < gj;
// rows and columns past the limits (padding, the count kernel's unwritten
// tri tiles) are never read.  A candidate is a hit when
//   kin = 0.5 + (((2 bh - 4 oh) - hi) - hj) / (4 min(hi, hj)) > threshold,
// each operation rounded on its own (`__f*_rn`, which nvcc never contracts
// into a fused multiply-add, and an IEEE divide): the reference's order
// (cuking.cu:286-307), bit for bit with the plain PyTorch version.  A pair
// with no hets gives NaN or -inf and never passes the strict `>`.  A hit
// writes (i, j, kin bits, ibs0, ibs1, ibs2) into column `slot` of the
// [6, capacity] int32 buffer; with `sym` it writes (min(gi, gj), max(gi, gj)).
//
// Slots.  A warp ballot and `__popc` rank each hit within its warp, a scan
// over the CTA's warp totals ranks it within the CTA, and one 64-bit
// `atomicAdd` per CTA with hits reserves the CTA's slots.  A hit is written
// only if its slot is below `capacity`, but the counter always advances by
// every hit, so it stays exact past capacity (a keep-all shard of 65,536
// samples has 2.1e9 pairs, past int32).  Slot order across CTAs is not
// deterministic; the host sorts by (i, j, kin) at the end.
//
// What bounds it.  Bytes: it reads the four kin counters of every candidate,
// 16 B per pair (16.8 MB for a 1024 x 1024 step, 5.0 us at 3.35 TB/s), and
// for each hit the other two counters and its 24 B row written, 32 B more
// (keep-all: 15.0 us); all coalesced.  The arithmetic is a few operations
// per pair, far below the card's rates.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kEmitThreads = 512;
constexpr int kEmitWarps = kEmitThreads / 32;

__device__ __forceinline__ float king_kin(int32_t bh, int32_t hi, int32_t hj, int32_t oh) {
  const float fbh = __int2float_rn(bh), fhi = __int2float_rn(hi);
  const float fhj = __int2float_rn(hj), foh = __int2float_rn(oh);
  const float numer =
      __fsub_rn(__fsub_rn(__fsub_rn(__fmul_rn(2.0f, fbh), __fmul_rn(4.0f, foh)), fhi), fhj);
  const float denom = __fmul_rn(4.0f, fminf(fhi, fhj));
  return __fadd_rn(0.5f, __fdiv_rn(numer, denom));
}

__global__ void __launch_bounds__(kEmitThreads)
king_emit_kernel(const int32_t* __restrict__ counts, long long ni, long long nj,
                 long long gi_base, long long gj_base, long long i_limit,
                 long long j_limit, float threshold, int strict, int sym,
                 int32_t* __restrict__ out, long long capacity,
                 unsigned long long* __restrict__ count) {
  __shared__ int warp_offset[kEmitWarps];
  __shared__ unsigned long long cta_base;

  const long long plane = ni * nj;
  const long long p = (long long)blockIdx.x * kEmitThreads + threadIdx.x;
  bool hit = false;
  long long gi = 0, gj = 0;
  int32_t bh = 0, oh = 0;
  float kin = 0.0f;
  if (p < plane) {
    const long long li = p / nj;
    gi = gi_base + li;
    gj = gj_base + (p - li * nj);
    if (gi < i_limit && gj < j_limit && (!strict || gi < gj)) {
      bh = counts[p];
      oh = counts[3 * plane + p];
      kin = king_kin(bh, counts[plane + p], counts[2 * plane + p], oh);
      hit = kin > threshold;
    }
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xFFFFFFFFu, hit);
  if (lane == 0) warp_offset[warp] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kEmitWarps; ++w) {
      const int n = warp_offset[w];
      warp_offset[w] = total;
      total += n;
    }
    cta_base = total ? atomicAdd(count, (unsigned long long)total) : 0ull;
  }
  __syncthreads();
  if (!hit) return;

  const unsigned long long slot =
      cta_base + warp_offset[warp] + __popc(ballot & ((1u << lane) - 1u));
  if (slot >= (unsigned long long)capacity) return;
  const uint32_t ch = (uint32_t)counts[4 * plane + p];
  const uint32_t shared = (uint32_t)counts[5 * plane + p];
  const uint32_t ibs2 = ch + (uint32_t)bh;
  const uint32_t ibs1 = shared - (uint32_t)oh - ibs2;
  const long long i = sym && gj < gi ? gj : gi;
  const long long j = sym && gj < gi ? gi : gj;
  int32_t* o = out + slot;
  o[0 * capacity] = (int32_t)i;
  o[1 * capacity] = (int32_t)j;
  o[2 * capacity] = __float_as_int(kin);
  o[3 * capacity] = oh;
  o[4 * capacity] = (int32_t)ibs1;
  o[5 * capacity] = (int32_t)ibs2;
}

}  // namespace

extern "C" {

// Appends the hits of one [6, ni, nj] int32 counter block (contiguous, on
// the current device) to `out` ([6, capacity] int32, contiguous) and adds
// their number to `*count` (one uint64; it stays exact past capacity).
// The caller checks shapes, devices and that ni * nj > 0.  Launches on
// `stream`, does not synchronise, and returns the CUDA error of the launch
// (0 on success).
int king_emit_launch(const void* counts, long long ni, long long nj, long long gi_base,
                     long long gj_base, long long i_limit, long long j_limit,
                     float threshold, int strict, int sym, void* out,
                     long long capacity, void* count, void* stream) {
  const long long blocks = (ni * nj + kEmitThreads - 1) / kEmitThreads;
  king_emit_kernel<<<(unsigned)blocks, kEmitThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(counts), ni, nj, gi_base, gj_base, i_limit, j_limit,
      threshold, strict, sym, static_cast<int32_t*>(out), capacity,
      static_cast<unsigned long long*>(count));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
