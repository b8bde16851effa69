"""Port of ``cuking_tpu/ops/king_math.py``: the KING kinship / IBS epilogue.

Implements exactly the reference's fp32 expression tree (cuking.cu:286-307),
which is Hail's "between-family" estimator::

    min_hets = min(num_het_i, num_het_j)
    kin  = 0.5 + (2*num_both_het - 4*num_opposing_hom
                  - num_het_i - num_het_j) / (4*min_hets)
    ibs0 = num_opposing_hom
    ibs2 = num_concordant_hom + num_both_het
    ibs1 = num_shared_sites - ibs0 - ibs2

The counts are exact int32, so fp32 parity holds as long as the operation
order is kept: the numerator folds left to right as
``((2f*bh - 4f*oh) - hi) - hj``, the denominator is materialised as
``4f * min_hets`` before the division, and ``0.5f`` is added last.  Every
step is one float32 tensor op, rounded on its own (PyTorch does not contract
them into fused multiply-adds).  ``min_hets == 0`` gives IEEE NaN or ±inf.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class KingCounts(NamedTuple):
    """The six per-pair counters accumulated over defined sites
    (cuking.cu:216-240)."""

    both_het: torch.Tensor        # popcount(het_i & het_j & defined)
    het_i: torch.Tensor           # popcount(het_i & defined)
    het_j: torch.Tensor           # popcount(het_j & defined)
    opposing_hom: torch.Tensor    # popcount(((ref_i&alt_j)|(alt_i&ref_j)) & defined)
    concordant_hom: torch.Tensor  # popcount(((ref_i&ref_j)|(alt_i&alt_j)) & defined)
    shared_sites: torch.Tensor    # popcount(defined)


class KingResult(NamedTuple):
    kin: torch.Tensor   # float32
    ibs0: torch.Tensor  # int32
    ibs1: torch.Tensor  # int32
    ibs2: torch.Tensor  # int32


def king_from_counts(counts: KingCounts) -> KingResult:
    """Counts → (kin, ibs0, ibs1, ibs2) with the reference's exact fp32
    op order (cuking.cu:289-307)."""
    bh = counts.both_het.to(torch.float32)
    hi = counts.het_i.to(torch.float32)
    hj = counts.het_j.to(torch.float32)
    oh = counts.opposing_hom.to(torch.float32)

    min_hets = torch.minimum(hi, hj)
    # ((2*bh - 4*oh) - hi) - hj, left-associative like the C expression.
    numer = 2.0 * bh - 4.0 * oh - hi - hj
    denom = 4.0 * min_hets
    kin = 0.5 + numer / denom

    ibs0 = counts.opposing_hom
    ibs2 = counts.concordant_hom + counts.both_het
    ibs1 = counts.shared_sites - ibs0 - ibs2
    return KingResult(kin=kin, ibs0=ibs0, ibs1=ibs1, ibs2=ibs2)
