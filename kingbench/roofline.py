"""The count kernel's yardstick: the card's peaks and the work of a shard.

The peaks are a frozen copy of ``cuking_tpu_torch/utils/bounds.py``'s as of
commit a4f2d36: NVIDIA's H100 SXM data sheet, dense, at the full 700 W
power limit.  A card set below that limit runs slower, so the harness
prints the card's power limit beside a share.

The work is counted from the shard, not from the kernel: 10 int8
operations (five products of a multiply and an add) per unique pair i < j
of the shard's samples and per site of the configuration.  Padding rows and
sites, tiles below the diagonal and whatever else a kernel launches are
left out, so the yardstick reads the same work whatever computes it.  The
bytes are the shard's planes read once: two bits per sample and site.
"""

from __future__ import annotations

PEAK_INT8_OPS = 1.979e15  # int8 tensor-core operations per second
PEAK_BYTES = 3.35e12      # HBM3 bytes per second
OPS_PER_PAIR_SITE = 10


def count_work(unique_pairs: int, samples: int, sites: int) -> tuple[int, int]:
    """(int8 operations, bytes) of one sweep of a shard of ``samples``
    stored samples and ``unique_pairs`` pairs, at ``sites`` sites."""
    return OPS_PER_PAIR_SITE * unique_pairs * sites, samples * sites // 4


def count_bound_s(unique_pairs: int, samples: int, sites: int) -> float:
    """The least time (s) the card could take for one sweep's counts."""
    ops, nbytes = count_work(unique_pairs, samples, sites)
    return max(ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES)
