"""Port of ``cuking_tpu/ops/king_jnp.py``: the reference-semantics popcount
path, in plain PyTorch on any device.

For every pair of an (i-panel, j-panel) tile it ANDs the packed planes word
by word and popcounts the six masked combinations, as the reference's
per-pair loop does (cuking.cu:216-240).  Counts are exact int32.  Memory
scales with ``row_block · NJ · W``, so the i-rows run in blocks.

It is a plain version, not a kernel: the semantics baseline for the count
kernel and the plain int8 path, behind ``--kernel popcount``.

torch has no popcount op.  :func:`popcount32` is SWAR arithmetic on the
int32 view of the words, one 16-bit half at a time so that no sum can leave
the int32 range; shifts of int32 copy the sign bit, so every shift is
masked.
"""

from __future__ import annotations

import torch

from cuking_tpu_torch.ops.king_math import KingCounts


def _popcount16(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each element of an int32 tensor with values in [0, 2¹⁶)."""
    x = (x & 0x5555) + ((x >> 1) & 0x5555)
    x = (x & 0x3333) + ((x >> 2) & 0x3333)
    x = (x & 0x0F0F) + ((x >> 4) & 0x0F0F)
    return (x & 0x00FF) + ((x >> 8) & 0x00FF)


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word of an int32 tensor, as int32."""
    return _popcount16(words & 0xFFFF) + _popcount16((words >> 16) & 0xFFFF)


def _row_block_counts(planes_i_blk: torch.Tensor, planes_j: torch.Tensor) -> KingCounts:
    """[2, BI, W] × [2, NJ, W] → six [BI, NJ] int32."""
    het_i = planes_i_blk[0][:, None, :]  # [BI, 1, W]
    hom_i = planes_i_blk[1][:, None, :]
    het_j = planes_j[0][None, :, :]      # [1, NJ, W]
    hom_j = planes_j[1][None, :, :]

    # Missing ⇔ both bits set; defined mask per cuking.cu:229.
    defined = ~(het_i & hom_i) & ~(het_j & hom_j)
    ref_i = ~het_i & ~hom_i
    ref_j = ~het_j & ~hom_j

    def count(mask):
        return popcount32(mask).sum(dim=-1, dtype=torch.int32)

    return KingCounts(
        both_het=count(het_i & het_j & defined),
        het_i=count(het_i & defined),
        het_j=count(het_j & defined),
        opposing_hom=count(((ref_i & hom_j) | (hom_i & ref_j)) & defined),
        concordant_hom=count(((ref_i & ref_j) | (hom_i & hom_j)) & defined),
        shared_sites=count(defined),
    )


def panel_counts_popcount(
    planes_i: torch.Tensor,
    planes_j: torch.Tensor,
    tri=None,
    row_block: int = 8,
) -> KingCounts:
    """Six KING counters for all (i, j) pairs of two packed panels.

    planes_i: [2, NI, W] int32, planes_j: [2, NJ, W] int32 → six [NI, NJ]
    int32 count matrices.  The i-rows run in blocks of ``row_block`` (the
    last block may be shorter).  ``tri`` (the diagonal-panel hint) is taken
    for interface parity with the count kernel and ignored.
    """
    del tri
    blocks = [
        _row_block_counts(planes_i[:, lo : lo + row_block], planes_j)
        for lo in range(0, planes_i.shape[1], row_block)
    ]
    return KingCounts(*(torch.cat(parts) for parts in zip(*blocks)))
