"""The emit kernel's yardstick in a keep-all cell: the least time the card
could take to emit every pair of a shard.

The bytes are counted from the shard, not from the launches, as
``cuking_tpu_torch/utils/bounds.py``'s ``emit_bound`` counts them for a
launch: the four kin counters of every candidate pair read, 16 B, and for
each row its other two counters read and its 24 B row written, 32 B more.
In a keep-all shard every unique pair i < j is a candidate and a row;
padding and the pairs below the diagonal are left out.  The peak is
``roofline.py``'s (the H100 SXM data sheet's HBM3 rate, at 700 W).
"""

from __future__ import annotations

from kingbench.roofline import PEAK_BYTES

CANDIDATE_BYTES = 16  # both_het, het_i, het_j, opposing_hom read
ROW_BYTES = 32        # concordant_hom and shared read, the row written


def emit_bytes(unique_pairs: int) -> int:
    """The bytes of emitting every pair of a shard of ``unique_pairs``."""
    return unique_pairs * (CANDIDATE_BYTES + ROW_BYTES)


def emit_bound_s(unique_pairs: int) -> float:
    """The least time (s) the card could take to emit them."""
    return emit_bytes(unique_pairs) / PEAK_BYTES
