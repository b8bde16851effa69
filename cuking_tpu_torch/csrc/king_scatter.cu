// Ingest's scatter on Hopper (sm_90a): each file's kept COO entries clear
// their bits in bit planes that live on the card.
//
// Replaces: no TPU kernel.  The JAX package (and the port's host paths)
// scatter on the host, into numpy planes (cuking_tpu/ops/bitset.py
// `clear_bits_coo`, native/packer.cpp `cuking_clear_bits`), which the engine
// then uploads; the reference scatters with AtomicClearBit into unified
// memory (cuking.cu:316-323, 674-703).  With the planes on the card, a task
// allocates no host planes and uploads none: the host sends 8 B per kept
// entry instead of the planes' 8 B per sample and 32 sites.
//
// Records.  `n` entries as two int32 runs of `n` each (one contiguous [2, n]
// block): the storage row, then `site << 2 | n_alt`.  The host has checked
// them (ops/king_scatter.py `check_entries`): n_alt in 0..2, site in
// [0, num_sites), and the row inside the planes.
//
// What it does.  One thread per entry, grid-stride.  Under the bit-plane-
// major map (ops/bitset.py) site s lives in word s % W at bit s / W; n_alt
// 0 clears the het and the hom bit, 1 the hom bit, 2 the het bit
// (cuking.cu:687-702).  Each clear is a 32-bit atomicAnd whose result is
// unused, which compiles to `red.global.and`: clears are idempotent and AND
// is order-free, so the planes come out bit for bit as the native packer's,
// duplicates included, on any schedule.
//
// What bounds it.  Bytes: 8 B of records read per entry, coalesced, and one
// or two 32 B sector read-modify-writes in the planes at random, so at most
// 72 B an entry (~2.6 ms for 1.2e8 entries at 3.35 TB/s).  A task's
// scatters are a few ms against its ingest's seconds on the host; the
// launches run on ingest's side stream while the host decodes other files.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kScatterThreads = 256;
constexpr long long kMaxBlocks = 4096;

__global__ void __launch_bounds__(kScatterThreads)
king_scatter_kernel(const int32_t* __restrict__ rows, const uint32_t* __restrict__ codes,
                    long long n, uint32_t* __restrict__ het, uint32_t* __restrict__ hom,
                    uint32_t words) {
  const long long stride = (long long)gridDim.x * kScatterThreads;
  for (long long k = (long long)blockIdx.x * kScatterThreads + threadIdx.x; k < n;
       k += stride) {
    const uint32_t code = codes[k];
    const uint32_t site = code >> 2, n_alt = code & 3u;
    const long long word = (long long)rows[k] * words + site % words;
    const uint32_t keep = ~(1u << (site / words));
    if (n_alt != 1u) atomicAnd(het + word, keep);
    if (n_alt != 2u) atomicAnd(hom + word, keep);
  }
}

}  // namespace

extern "C" {

// Clears the bits of `n` records (`records`, a contiguous [2, n] int32 block
// on the current device) in `planes` ([2, rows, words] 32-bit words,
// contiguous, all ones where nothing was cleared).  The caller checks the
// records and that n > 0.  Launches on `stream`, does not synchronise, and
// returns the CUDA error of the launch (0 on success).
int king_scatter_launch(const void* records, long long n, void* planes, long long rows,
                        long long words, void* stream) {
  long long blocks = (n + kScatterThreads - 1) / kScatterThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const int32_t* rec = static_cast<const int32_t*>(records);
  uint32_t* het = static_cast<uint32_t*>(planes);
  king_scatter_kernel<<<(unsigned)blocks, kScatterThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      rec, reinterpret_cast<const uint32_t*>(rec + n), n, het, het + rows * words,
      static_cast<uint32_t>(words));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
