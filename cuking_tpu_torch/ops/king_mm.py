"""Port of ``cuking_tpu/ops/king_mm.py``: the plain PyTorch count path.

All six counters of cuking.cu:216-240 are bilinear in three per-site 0/1
indicators per sample — H (het), A (hom-alt), D (defined) — because
``hom-ref = D − H − A`` and every masked popcount is an inner product over
sites:

    both_het[i,j]       = <H_i, H_j>
    het_i[i,j]          = <H_i, D_j>
    het_j[i,j]          = <D_i, H_j>
    shared_sites[i,j]   = <D_i, D_j>
    opposing_hom[i,j]   = <R_i, A_j> + <A_i, R_j>
                        = DA + AD − HA − AH − 2·AA
    concordant_hom[i,j] = <R_i, R_j> + <A_i, A_j>
                        = DD − DH − DA − HD + HH + HA − AD + AH + 2·AA

with XY := X_i · Y_jᵀ.  Stacking X = [H; A; D] per panel gives one
``[3·NI, S] × [3·NJ, S]ᵀ`` int8→int32 product per site chunk
(``torch._int_mm``) that yields all nine blocks; counts are integer-exact.

This is the plain version of the CUDA count kernel (ops/king_cuda.py): the
wrapper runs it for CPU tensors, and the tests and ``chip_smoke.py`` hold the
kernel against it.  Planes are int32 views of the uint32 words, because CPU
PyTorch has no ``>>`` or ``~`` on uint32; shifts of int32 are arithmetic, so
every shift is followed by ``& 1``.
"""

from __future__ import annotations

import torch

from cuking_tpu_torch.ops.king_math import KingCounts


def unpack_plane(words: torch.Tensor) -> torch.Tensor:
    """[N, W] int32 → [N, 32·W] int8 bits, site order s = b·W + w (bitset.py)."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = (words.unsqueeze(1) >> shifts.view(1, 32, 1)) & 1
    return bits.to(torch.int8).reshape(words.shape[0], 32 * words.shape[1])


def indicator_planes(planes: torch.Tensor) -> torch.Tensor:
    """[2, N, W] packed → [3, N, 32·W] int8 H/A/D indicators.

    Bitwise on packed words first, then one unpack per indicator:
    H = het & ~hom, A = ~het & hom, D = ~(het & hom) — missing is (1,1).
    """
    het, hom = planes[0], planes[1]
    h = het & ~hom
    a = ~het & hom
    d = ~(het & hom)
    return torch.stack([unpack_plane(p) for p in (h, a, d)], dim=0)


def counts_from_gram(gram: torch.Tensor, ni: int, nj: int) -> KingCounts:
    """[3·NI, 3·NJ] stacked-indicator Gram matrix → six [NI, NJ] counters."""
    blk = lambda r, c: gram[r * ni : (r + 1) * ni, c * nj : (c + 1) * nj]
    HH, HA, HD = blk(0, 0), blk(0, 1), blk(0, 2)
    AH, AA, AD = blk(1, 0), blk(1, 1), blk(1, 2)
    DH, DA, DD = blk(2, 0), blk(2, 1), blk(2, 2)
    return KingCounts(
        both_het=HH,
        het_i=HD,
        het_j=DH,
        opposing_hom=DA + AD - HA - AH - 2 * AA,
        concordant_hom=DD - DH - DA - HD + HH + HA - AD + AH + 2 * AA,
        shared_sites=DD,
    )


def _pad_rows(x: torch.Tensor) -> torch.Tensor:
    """Zero rows up to a multiple of 8 and at least 24: CUDA's ``_int_mm``
    takes only those shapes.  Zero rows add nothing to the Gram."""
    rows = max(24, -(-x.shape[0] // 8) * 8)
    if rows == x.shape[0]:
        return x
    return torch.cat([x, x.new_zeros(rows - x.shape[0], x.shape[1])])


def panel_counts_matmul(
    planes_i: torch.Tensor,
    planes_j: torch.Tensor,
    site_chunk_words: int = 128,
) -> KingCounts:
    """Six KING counters via the stacked-indicator int8 product.

    planes_i: [2, NI, W] int32, planes_j: [2, NJ, W] int32 → six [NI, NJ]
    int32.  The site axis runs in chunks of ``site_chunk_words`` (the last
    one may be shorter), so the int8 indicators never exceed
    ``3 · N · 32 · site_chunk_words`` bytes per side.  It computes every
    pair: unlike the CUDA kernel it has no diagonal-tile skip.
    """
    ni, nj = planes_i.shape[1], planes_j.shape[1]
    w = planes_i.shape[2]
    gram = None
    for lo in range(0, w, site_chunk_words):
        hi = min(lo + site_chunk_words, w)
        xi = _pad_rows(indicator_planes(planes_i[:, :, lo:hi]).reshape(3 * ni, -1))
        xj = _pad_rows(indicator_planes(planes_j[:, :, lo:hi]).reshape(3 * nj, -1))
        part = torch._int_mm(xi, xj.t())
        gram = part if gram is None else gram.add_(part)
    return counts_from_gram(gram[: 3 * ni, : 3 * nj], ni, nj)
