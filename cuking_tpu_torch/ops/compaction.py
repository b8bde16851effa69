"""Port of ``cuking_tpu/ops/compaction.py``: thresholded hits into one
device-resident result buffer — the analogue of the reference's
``KingResult[max_results]`` array and atomic slot counter
(cuking.cu:296-313, 747-751).

PyTorch runs eagerly, so each panel-pair step compacts its mask with
``nonzero`` (which returns the exact hit count to the host) and gathers the
six fields; the buffer appends them at its running count.  The TPU package's
``top_k`` fast path and its scatter fallback worked around slow TPU scatters
under static shapes and are not needed here.

Two buffers: the engine's :class:`ResultBuffer` grows and raises as soon as
a step crosses ``max_results``; the ring's per-position :class:`HitBuffer`
has a fixed capacity, keeps its count exact past it and never raises.
"""

from __future__ import annotations

import numpy as np
import torch

from cuking_tpu_torch.ops.king_math import KingResult
from cuking_tpu_torch.utils.status import ResourceExhaustedError


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


class ResultBuffer:
    """One [6, capacity] int32 device buffer with a running hit count.

    It grows to the next power of two of the needed size, capped at
    ``max_results``, by copying into a larger buffer; a total beyond
    ``max_results`` raises ResourceExhausted with the reference's message
    (cuking.cu:747-751) as soon as a step crosses it."""

    def __init__(self, capacity: int, max_results: int, device, logger=None):
        self.max_results = max_results
        self.buf = torch.empty((6, capacity), dtype=torch.int32, device=device)
        self.count = 0
        self._logger = logger

    @property
    def capacity(self) -> int:
        return self.buf.shape[1]

    def append(self, hits: torch.Tensor) -> None:
        total = self.count + hits.shape[1]
        if total > self.max_results:
            raise ResourceExhaustedError(
                "Could not store all results: try increasing the "
                "--max_results parameter."
            )
        if total > self.capacity:
            new_capacity = min(ceil_pow2(total), self.max_results)
            if self._logger is not None:
                self._logger.print(
                    f"Result buffer full ({total} hits > {self.capacity} "
                    f"slots); growing it to {new_capacity}."
                )
            grown = self.buf.new_empty((6, new_capacity))
            grown[:, : self.count] = self.buf[:, : self.count]
            self.buf = grown
        self.buf[:, self.count : total] = hits
        self.count = total

    def to_host(self) -> np.ndarray:
        """The hits as one [6, count] int32 host array (one transfer)."""
        return self.buf[:, : self.count].cpu().numpy()


class HitBuffer:
    """One ring position's fixed [6, capacity] int32 device buffer.

    Unlike :class:`ResultBuffer` it never grows and never raises: hits past
    ``capacity`` are dropped while ``count`` stays the exact total, as in the
    TPU package's ring (``accumulate_hits``).  The ring decides overflow
    only after the sweep, from the counts of every position, so that in a
    multi-process run every rank raises or retries together instead of one
    rank leaving its peers waiting in the next collective."""

    def __init__(self, capacity: int, device):
        self.buf = torch.empty((6, capacity), dtype=torch.int32, device=device)
        self.count = 0

    @property
    def capacity(self) -> int:
        return self.buf.shape[1]

    def append(self, hits: torch.Tensor) -> None:
        take = min(hits.shape[1], max(0, self.capacity - self.count))
        if take:
            self.buf[:, self.count : self.count + take] = hits[:, :take]
        self.count += hits.shape[1]
