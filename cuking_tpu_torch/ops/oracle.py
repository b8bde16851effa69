"""Port of ``cuking_tpu/ops/oracle.py`` (a numpy copy).

Naive O(N_i · N_j · S) numpy oracle for the six KING counters.

Pure test reference: computes counts directly from a dense genotype matrix
(values 0/1/2, -1 = missing) with the definitions at cuking.cu:216-240, with
no packing, no tiling, no device code.  Used to validate every accelerated
path (the plain int8 product and the CUDA kernel)."""

from __future__ import annotations

import numpy as np

from cuking_tpu_torch.ops.king_math import KingCounts


def oracle_counts(g_i: np.ndarray, g_j: np.ndarray) -> KingCounts:
    """g_i: [NI, S], g_j: [NJ, S] dense genotypes → six [NI, NJ] int64 count
    matrices."""
    het_i = (g_i == 1)[:, None, :]
    alt_i = (g_i == 2)[:, None, :]
    ref_i = (g_i == 0)[:, None, :]
    def_i = (g_i >= 0)[:, None, :]
    het_j = (g_j == 1)[None, :, :]
    alt_j = (g_j == 2)[None, :, :]
    ref_j = (g_j == 0)[None, :, :]
    def_j = (g_j >= 0)[None, :, :]

    defined = def_i & def_j
    return KingCounts(
        both_het=np.sum(het_i & het_j & defined, axis=-1),
        het_i=np.sum(het_i & defined, axis=-1),
        het_j=np.sum(het_j & defined, axis=-1),
        opposing_hom=np.sum(((ref_i & alt_j) | (alt_i & ref_j)) & defined, axis=-1),
        concordant_hom=np.sum(((ref_i & ref_j) | (alt_i & alt_j)) & defined, axis=-1),
        shared_sites=np.sum(defined, axis=-1),
    )


def oracle_king(g_i: np.ndarray, g_j: np.ndarray):
    """Counts → (kin fp32, ibs0/1/2) with the reference fp32 op order; numpy
    twin of king_math.king_from_counts for hermetic test comparison."""
    c = oracle_counts(g_i, g_j)
    bh = c.both_het.astype(np.float32)
    hi = c.het_i.astype(np.float32)
    hj = c.het_j.astype(np.float32)
    oh = c.opposing_hom.astype(np.float32)
    min_hets = np.minimum(hi, hj)
    with np.errstate(divide="ignore", invalid="ignore"):
        kin = np.float32(0.5) + (
            np.float32(2.0) * bh - np.float32(4.0) * oh - hi - hj
        ) / (np.float32(4.0) * min_hets)
    ibs0 = c.opposing_hom
    ibs2 = c.concordant_hom + c.both_het
    ibs1 = c.shared_sites - ibs0 - ibs2
    return kin, ibs0, ibs1, ibs2
