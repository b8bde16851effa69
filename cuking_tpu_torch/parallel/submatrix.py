"""Port of ``cuking_tpu/parallel/submatrix.py`` (a copy).

Upper-triangular shard geometry.

Re-derivation of the reference's ``Submatrix`` algebra (cuking.cu:129-179):
the N×N relatedness matrix is split into ``split_factor × split_factor``
equally sized blocks; only the ``k(k+1)/2`` upper-triangular blocks are
computed (relatedness is symmetric), each identified by a linear
``shard_index``.  A diagonal block stores one sample range; an off-diagonal
block stores the row range followed by the column range (cuking.cu:158-175).

The linear-index → (block_i, block_j) mapping deliberately scans row sums
instead of using the closed-form inverse, matching the reference's
numeric-safety choice (cuking.cu:133-144); split factors are tiny so this is
never hot.
"""

from __future__ import annotations

from dataclasses import dataclass

from cuking_tpu_torch.utils.status import InvalidArgumentError


def num_shards(split_factor: int) -> int:
    """Number of upper-triangular shards: k(k+1)/2 (cuking.cu:460)."""
    return split_factor * (split_factor + 1) // 2


def shard_to_block(split_factor: int, shard_index: int) -> tuple[int, int]:
    """Maps a linear upper-triangular shard index to (block_i, block_j).

    Mirrors the row-sum scan at cuking.cu:136-144.
    """
    tri_sum = 0
    for i in range(split_factor):
        tri_sum += split_factor - i
        if shard_index < tri_sum:
            return i, split_factor - tri_sum + shard_index
    raise InvalidArgumentError("Invalid shard index")


def _ceil_div(a: int, b: int) -> int:
    return (a + b - 1) // b


@dataclass(frozen=True)
class Submatrix:
    """Bounds of the relatedness submatrix one shard computes.

    Semantics match cuking.cu:129-179: ``i_begin:i_end`` is the sample row
    range, ``j_begin:j_end`` the sample column range.  The strict ``i < j``
    upper-triangle constraint is applied later per pair (cuking.cu:199), not
    here — a diagonal block simply has identical ranges.
    """

    i_begin: int
    i_end: int
    j_begin: int
    j_end: int

    @classmethod
    def create(
        cls, num_samples: int, split_factor: int, shard_index: int
    ) -> "Submatrix":
        if split_factor == 0:
            raise InvalidArgumentError("Invalid split factor")
        if shard_index >= num_shards(split_factor):
            raise InvalidArgumentError("Invalid shard index")
        block_i, block_j = shard_to_block(split_factor, shard_index)
        size = _ceil_div(num_samples, split_factor)
        i_begin = block_i * size
        i_end = min(i_begin + size, num_samples)
        j_begin = block_j * size
        j_end = min(j_begin + size, num_samples)
        return cls(i_begin, i_end, j_begin, j_end)

    @property
    def num_rows(self) -> int:
        return self.i_end - self.i_begin

    @property
    def num_cols(self) -> int:
        return self.j_end - self.j_begin

    @property
    def is_diagonal(self) -> bool:
        return self.i_begin == self.j_begin

    @property
    def num_samples(self) -> int:
        """Samples stored for this shard; diagonal blocks store one range
        (cuking.cu:159-162)."""
        return self.num_rows if self.is_diagonal else self.num_rows + self.num_cols

    @property
    def unique_pairs(self) -> int:
        """The shard's pairs i < j of distinct samples: every pair of a
        whole-matrix export (``--keep_all``)."""
        if self.is_diagonal:
            return self.num_rows * (self.num_rows - 1) // 2
        return self.num_rows * self.num_cols

    def contains(self, index) -> bool:
        """Whether a global sample index belongs to this shard
        (cuking.cu:165-168).  Accepts scalars or numpy arrays."""
        return ((self.i_begin <= index) & (index < self.i_end)) | (
            (self.j_begin <= index) & (index < self.j_end)
        )

    def sample_offset(self, index):
        """Global sample index → linear storage offset (cuking.cu:171-175).

        The i-range is stored before the j-range.  Accepts scalars or numpy
        arrays; callers must only pass indices for which ``contains`` is true.
        """
        import numpy as np

        index = np.asarray(index)
        # Branch-free (np.where is far slower on large arrays on some hosts):
        # i-range → index - i_begin; j-range adds the stored-row rebase.
        in_j = (index >= self.i_end).astype(index.dtype)
        return index - self.i_begin + in_j * (
            (self.i_end - self.i_begin) - self.j_begin + self.i_begin
        )

    def stored_sample_indices(self):
        """Global sample indices in storage order (i-range then j-range)."""
        import numpy as np

        if self.is_diagonal:
            return np.arange(self.i_begin, self.i_end, dtype=np.int64)
        return np.concatenate(
            [
                np.arange(self.i_begin, self.i_end, dtype=np.int64),
                np.arange(self.j_begin, self.j_end, dtype=np.int64),
            ]
        )
