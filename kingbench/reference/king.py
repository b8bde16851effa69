"""The plain reference: every pair of a shard, from the genotypes.

KING's six counters by their definitions (cuking.cu:216-240), over the
sites where both samples are defined: both het; i het; j het; opposing
homozygotes; concordant homozygotes; sites shared.  Each sample's
genotypes become three 0/1 rows, hom-ref, het and hom-alt (a missing site
is none of them), and one int8 product of the stacked rows gives all nine
class-by-class counts of a block of pairs at once, exact in int32.  Then
the reference's float32 expression (cuking.cu:286-307), one operation and
one rounding at a time::

    kin = 0.5 + (((2 bh - 4 oh) - hi) - hj) / (4 min(hi, hj))
    ibs0 = oh;  ibs2 = concordant + bh;  ibs1 = shared - ibs0 - ibs2

and the pairs with ``kin > threshold`` (float32, strict), as rows (i, j,
kin bits, ibs0, ibs1, ibs2) sorted by (i, j).  ``dtype`` bfloat16 runs the
same expression a precision below the configuration's: the control.

Plain PyTorch on any device; it imports nothing of the port.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

HOM_REF, HET, HOM_ALT = 0, 1, 2


def _onehot(codes: torch.Tensor) -> torch.Tensor:
    """[n, s] genotypes → [3n, s] int8: hom-ref rows, het rows, hom-alt
    rows, the sites padded with zeros to a multiple of 8 (int8 products
    want it)."""
    n, s = codes.shape
    s8 = -(-s // 8) * 8
    out = torch.zeros((3, n, s8), dtype=torch.int8, device=codes.device)
    for k, value in enumerate((HOM_REF, HET, HOM_ALT)):
        out[k, :, :s] = codes == value
    return out.view(3 * n, s8)


def _pad_rows(x: torch.Tensor) -> torch.Tensor:
    """Zero rows up to a multiple of 8 and at least 24, the shapes that
    CUDA's int8 product takes; zero rows count nothing."""
    rows = max(24, -(-x.shape[0] // 8) * 8)
    return x if rows == x.shape[0] else torch.cat([x, x.new_zeros((rows - x.shape[0], x.shape[1]))])


def _int8_gram(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x @ y.T, int8 in, int32 out."""
    return torch._int_mm(_pad_rows(x), _pad_rows(y).t())[:x.shape[0], :y.shape[0]]


def class_counts(get_i: Callable, get_j: Callable, sites: int, chunk: int) -> torch.Tensor:
    """[3, 3, ni, nj] int32: sites where i is of class a and j of class b,
    summed over site chunks; ``get_i(lo, hi)`` gives i's genotypes at sites
    [lo, hi)."""
    total = None
    for lo in range(0, sites, chunk):
        hi = min(lo + chunk, sites)
        gi, gj = get_i(lo, hi), get_j(lo, hi)
        c = _int8_gram(_onehot(gi), _onehot(gj)).reshape(3, gi.shape[0], 3, gj.shape[0])
        total = c if total is None else total.add_(c)
        del gi, gj, c
    return total.permute(0, 2, 1, 3)


def king(c: torch.Tensor, dtype=torch.float32) -> tuple:
    """Class counts → (kin in ``dtype``, ibs0, ibs1, ibs2)."""
    r, h, a = HOM_REF, HET, HOM_ALT
    both_het = c[h, h]
    het_i = c[h, r] + c[h, h] + c[h, a]
    het_j = c[r, h] + c[h, h] + c[a, h]
    opposing = c[r, a] + c[a, r]
    concordant = c[r, r] + c[a, a]
    shared = c.sum(dim=(0, 1))
    bh, hi, hj, oh = (x.to(dtype) for x in (both_het, het_i, het_j, opposing))
    numer = ((bh * 2 - oh * 4) - hi) - hj
    denom = torch.minimum(hi, hj) * 4
    kin = numer / denom + 0.5
    ibs2 = concordant + both_het
    return kin, opposing, shared - opposing - ibs2, ibs2


def shard_rows(get_rows: Callable, i_ids: np.ndarray, j_ids: np.ndarray | None,
               sites: int, threshold: float, *, dtype=torch.float32,
               block: int = 8192, site_chunk: int = 1 << 17) -> np.ndarray:
    """Every pair of a shard above ``threshold``: [n, 6] int64 rows (i, j,
    kin bits, ibs0, ibs1, ibs2) sorted by (i, j).  ``get_rows(ids, lo,
    hi)`` gives the genotypes of global samples ``ids`` at sites [lo, hi)
    on the device the products run on.  With ``j_ids`` None the shard is
    diagonal: its pairs i < j within ``i_ids``."""
    diagonal = j_ids is None
    j_ids = i_ids if diagonal else j_ids
    thr = torch.tensor(threshold, dtype=dtype)
    out = []
    for a in range(0, len(i_ids), block):
        bi = i_ids[a:a + block]
        for b in range(a if diagonal else 0, len(j_ids), block):
            bj = j_ids[b:b + block]
            c = class_counts(lambda lo, hi: get_rows(bi, lo, hi),
                             lambda lo, hi: get_rows(bj, lo, hi), sites, site_chunk)
            kin, ibs0, ibs1, ibs2 = king(c, dtype)
            del c
            gi = torch.as_tensor(bi, device=kin.device)[:, None]
            gj = torch.as_tensor(bj, device=kin.device)[None, :]
            hit = kin > thr.to(kin.device)
            if diagonal:
                hit &= gi < gj
            ii, jj = torch.nonzero(hit, as_tuple=True)
            bits = kin[ii, jj].to(torch.float32).cpu().numpy().view(np.uint32)
            out.append(np.stack([bi[ii.cpu().numpy()], bj[jj.cpu().numpy()], bits,
                                 ibs0[ii, jj].cpu().numpy(), ibs1[ii, jj].cpu().numpy(),
                                 ibs2[ii, jj].cpu().numpy()], axis=1).astype(np.int64))
            del kin, ibs0, ibs1, ibs2, hit
    rows = np.concatenate(out) if out else np.zeros((0, 6), np.int64)
    return rows[np.lexsort((rows[:, 1], rows[:, 0]))]
