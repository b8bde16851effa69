"""A shard's geometry, worked out here and not read from the port.

cuKING splits a cohort of N samples into k blocks of ceil(N / k) samples
and numbers the k(k+1)/2 block pairs (a, b), a <= b, row by row
(cuking.cu:137-175).  A shard stores its i-block's samples first, then,
off the diagonal, its j-block's, each section padded with all-missing rows
to a multiple of the panel.  A diagonal shard's pairs are i < j inside the
block; an off-diagonal shard's are every i of its i-block with every j of
its j-block.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


@dataclass(frozen=True)
class Shard:
    samples: int
    split_factor: int
    shard_index: int
    panel: int

    @property
    def blocks(self) -> tuple[int, int]:
        """(i-block, j-block) of the shard index."""
        k, index = self.split_factor, self.shard_index
        for a in range(k):
            for b in range(a, k):
                if index == 0:
                    return a, b
                index -= 1
        raise ValueError(f"shard {self.shard_index} of split {k} does not exist")

    @property
    def block_size(self) -> int:
        return _ceil_div(self.samples, self.split_factor)

    def _range(self, block: int) -> tuple[int, int]:
        lo = block * self.block_size
        return lo, min(lo + self.block_size, self.samples)

    @property
    def i_range(self) -> tuple[int, int]:
        return self._range(self.blocks[0])

    @property
    def j_range(self) -> tuple[int, int]:
        return self._range(self.blocks[1])

    @property
    def diagonal(self) -> bool:
        return self.blocks[0] == self.blocks[1]

    def sample_ids(self) -> np.ndarray:
        """The shard's global sample indices in storage order."""
        i = np.arange(*self.i_range)
        return i if self.diagonal else np.concatenate([i, np.arange(*self.j_range)])

    def _padded(self, lo_hi: tuple[int, int]) -> int:
        return max(_ceil_div(lo_hi[1] - lo_hi[0], self.panel), 1) * self.panel

    @property
    def stored_rows(self) -> int:
        """Rows of storage, padding included."""
        rows = self._padded(self.i_range)
        return rows if self.diagonal else rows + self._padded(self.j_range)

    def storage_rows(self) -> np.ndarray:
        """The storage row of each sample of :meth:`sample_ids`."""
        ni = self.i_range[1] - self.i_range[0]
        i = np.arange(ni)
        if self.diagonal:
            return i
        nj = self.j_range[1] - self.j_range[0]
        return np.concatenate([i, self._padded(self.i_range) + np.arange(nj)])

    @property
    def unique_pairs(self) -> int:
        """The shard's pairs i < j of distinct samples."""
        ni = self.i_range[1] - self.i_range[0]
        if self.diagonal:
            return ni * (ni - 1) // 2
        return ni * (self.j_range[1] - self.j_range[0])
