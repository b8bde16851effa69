"""The plain reference of a keep-all cell: every pair of a shard, whatever
its kin.

The counts and kin are ``king.py``'s (:func:`~kingbench.reference.king.class_counts`,
:func:`~kingbench.reference.king.king`); only the selection differs.  No
threshold is applied, so a pair whose kin is NaN or ±inf (a sample with no
het site gives 0 or a negative number over 0) is a row like any other: the
rows are exactly the shard's pairs i < j, as ``hl.king`` returns them.

Plain PyTorch on any device; it imports nothing of the port.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from kingbench.reference.king import class_counts, king


def shard_rows_all(get_rows: Callable, i_ids: np.ndarray, j_ids: np.ndarray | None,
                   sites: int, *, dtype=torch.float32, block: int = 8192,
                   site_chunk: int = 1 << 17) -> np.ndarray:
    """Every pair of a shard: [n, 6] int64 rows (i, j, kin bits, ibs0, ibs1,
    ibs2) sorted by (i, j), kin in ``dtype`` (stored as float32 bits).
    ``get_rows(ids, lo, hi)`` gives the genotypes of global samples ``ids``
    at sites [lo, hi) on the device the products run on.  With ``j_ids``
    None the shard is diagonal: its pairs i < j within ``i_ids``."""
    diagonal = j_ids is None
    j_ids = i_ids if diagonal else j_ids
    out = []
    for a in range(0, len(i_ids), block):
        bi = i_ids[a:a + block]
        for b in range(a if diagonal else 0, len(j_ids), block):
            bj = j_ids[b:b + block]
            c = class_counts(lambda lo, hi: get_rows(bi, lo, hi),
                             lambda lo, hi: get_rows(bj, lo, hi), sites, site_chunk)
            kin, ibs0, ibs1, ibs2 = king(c, dtype)
            del c
            keep = torch.ones(kin.shape, dtype=torch.bool, device=kin.device)
            if diagonal:
                gi = torch.as_tensor(bi, device=kin.device)[:, None]
                gj = torch.as_tensor(bj, device=kin.device)[None, :]
                keep &= gi < gj
            ii, jj = torch.nonzero(keep, as_tuple=True)
            bits = kin[ii, jj].to(torch.float32).cpu().numpy().view(np.uint32)
            out.append(np.stack([bi[ii.cpu().numpy()], bj[jj.cpu().numpy()], bits,
                                 ibs0[ii, jj].cpu().numpy(), ibs1[ii, jj].cpu().numpy(),
                                 ibs2[ii, jj].cpu().numpy()], axis=1).astype(np.int64))
            del kin, ibs0, ibs1, ibs2, keep
    rows = np.concatenate(out) if out else np.zeros((0, 6), np.int64)
    return rows[np.lexsort((rows[:, 1], rows[:, 0]))]
