"""Port of ``cuking_tpu/ops/compaction.py``: thresholded hits in one
device-resident result buffer — the analogue of the reference's
``KingResult[max_results]`` array and atomic slot counter
(cuking.cu:296-313, 747-751).

:class:`HitBuffer` has the contract of the JAX package's
``accumulate_hits``: a fixed capacity, and a running hit count that stays
exact past it.  The count is a device int64 tensor, so a sweep that appends
through the emit kernel (``ops/king_emit.py``) need not read the device
until it ends; callers decide overflow from the final count (the engine
re-runs at a larger capacity, the ring all-reduces the counts first).  To
stop early, the engine copies the count into host memory every few steps
(:meth:`HitBuffer.snapshot`) and waits only for a copy several snapshots
old (:meth:`HitBuffer.wait_oldest`), with later steps queued behind it.

:func:`compact_hits` and :meth:`HitBuffer.append` belong to the emit
kernel's plain version: ``nonzero`` of a step's mask, a gather of the six
fields, and a write at the running count.  The TPU package's ``top_k`` fast
path and its scatter fallback worked around slow TPU scatters under static
shapes and are not needed here.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from cuking_tpu_torch.ops.king_math import KingResult


def ceil_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def compact_hits(
    mask: torch.Tensor, i_base: int, j_base: int, res: KingResult
) -> torch.Tensor:
    """Hits of an [NI, NJ] mask → [6, n] int32 rows ``(i, j, kin bits, ibs0,
    ibs1, ibs2)`` in row-major order.  ``mask`` may be a leading sub-block of
    the result tensors; ``i_base``/``j_base`` are the global indices of its
    first row and column."""
    li, lj = mask.nonzero(as_tuple=True)
    return torch.stack(
        [
            (li + i_base).to(torch.int32),
            (lj + j_base).to(torch.int32),
            res.kin[li, lj].view(torch.int32),
            res.ibs0[li, lj],
            res.ibs1[li, lj],
            res.ibs2[li, lj],
        ]
    )


class HitBuffer:
    """One fixed [6, capacity] int32 device buffer of rows ``(i, j, kin
    bits, ibs0, ibs1, ibs2)`` and ``count``, a 0-dim int64 tensor on the
    same device: the exact number of hits appended, which may pass
    ``capacity`` (hits past it are dropped)."""

    def __init__(self, capacity: int, device):
        self.buf = torch.empty((6, capacity), dtype=torch.int32, device=device)
        self.count = torch.zeros((), dtype=torch.int64, device=device)
        self._snapshots: deque = deque()
        self.waits = 0

    @property
    def capacity(self) -> int:
        return self.buf.shape[1]

    def append(self, hits: torch.Tensor) -> None:
        """Appends [6, n] rows at the running count (the plain version; it
        reads the count, so on a card it waits for the device)."""
        start = int(self.count)
        take = min(hits.shape[1], max(0, self.capacity - start))
        if take:
            self.buf[:, start : start + take] = hits[:, :take]
        self.count += hits.shape[1]

    def rows(self, total: int) -> np.ndarray:
        """The first ``min(total, capacity)`` rows as one [6, n] int32 host
        array (one transfer)."""
        return self.buf[:, : min(total, self.capacity)].cpu().numpy()

    def snapshot(self) -> None:
        """Starts a copy of the count into pinned host memory, behind an
        event, and returns without waiting for it."""
        host = torch.empty((), dtype=torch.int64, pin_memory=self.count.is_cuda)
        host.copy_(self.count, non_blocking=True)
        event = None
        if self.count.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(self.count.device))
        self._snapshots.append((host, event))

    @property
    def pending(self) -> int:
        """Snapshots taken and not yet read."""
        return len(self._snapshots)

    def wait_oldest(self) -> int:
        """Waits for the oldest pending snapshot's copy to land and returns
        it.  This is a deliberate wait for the device, counted in
        ``waits``."""
        host, event = self._snapshots.popleft()
        if event is not None:
            event.synchronize()
        self.waits += 1
        return int(host)
