"""The least time the card could take for one launch of each kernel.

A bound is the larger of two times: the bytes the function must move (each
input read once, each output written once) over the card's memory rate, and
the operations it does over the card's peak rate for their type.  The peaks
are NVIDIA's H100 SXM data sheet's, dense, at the full 700 W power limit: a
card set below it runs slower, so a reading is stated beside the card's
power limit.  ``chip_smoke.py`` and ``bench_torch.py`` set their kernels'
times beside these bounds, and ``tools/torch_chip_probe.py`` the card's
measured int8 and bf16 rates beside the peaks.
"""

from __future__ import annotations

PEAK_INT8_OPS = 1.979e15  # int8 tensor-core operations per second
PEAK_BF16_OPS = 989e12    # bf16 tensor-core operations per second
PEAK_BYTES = 3.35e12      # HBM3 bytes per second
PEAK_FP32_OPS = 67e12     # float32 outside the tensor cores


def count_ops(ni: int, nj: int, words: int) -> int:
    """The int8 operations of one count launch: five products of 2
    operations per pair and padded site."""
    return 10 * ni * nj * 32 * words


def count_bound(ni: int, nj: int, words: int) -> tuple[float, str]:
    """The least time (ms) one count launch could take, and what bounds it:
    its operations (:func:`count_ops`) against the planes read once and the
    six int32 counters written once."""
    ops = count_ops(ni, nj, words)
    nbytes = 2 * (ni + nj) * words * 4 + 6 * ni * nj * 4
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def emit_bound(pairs: int, hits: int) -> tuple[float, str]:
    """The least time (ms) one emit launch could take over ``pairs``
    candidate pairs, and what bounds it: the bytes the function needs (the
    four kin counters of every candidate, 16 B; for each hit the other two
    counters, 8 B, and its row written, 24 B), against ~10 operations per
    pair (the kin expression and the mask) at the card's non-tensor float32
    rate."""
    t_bytes = (16 * pairs + 32 * hits) / PEAK_BYTES
    t_ops = 10 * pairs / PEAK_FP32_OPS
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


def scatter_bound(entries: int, clears: int) -> tuple[float, str]:
    """The least time (ms) one scatter launch could take over ``entries``
    records that clear ``clears`` bits (one or two an entry), and what
    bounds it: the records read once, 8 B an entry, and one 32 B sector
    read and written back in place for each clear (the planes are far
    larger than the L2, and the clears fall at random)."""
    return 1e3 * (8 * entries + 32 * clears) / PEAK_BYTES, "bytes"
