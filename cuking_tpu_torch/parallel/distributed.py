"""Port of ``cuking_tpu/parallel/distributed.py``: host-sharded plane
storage for a ring that spans several processes.

The reference's memory relief is process-level sharding: each GPU job stores
only its Submatrix's sample ranges (cuking.cu:507-517, README.md:94-98).  On
a ring across processes the analogous property is that each PROCESS holds
only the sample row blocks of its own ring positions: ingest filters the COO
entries to those rows (like the shard ingest filter, cuking.cu:675-678) and
packs them into per-position blocks, which ``to_device_blocks`` places on
the positions' devices.  No process ever holds the whole cohort's bitset.

Passing a ``submatrix`` stores only that shard's range(s) (the i-range, plus
the j-range for an off-diagonal shard, cuking.cu:158-175), each itself split
over the ring, so the two memory-relief axes compose.

A single-process mesh degenerates to "every position is local".
"""

from __future__ import annotations

import numpy as np
import torch

from cuking_tpu_torch.ops import bitset
from cuking_tpu_torch.ops.bitset import PlaneLayout


class HostShardedStorage:
    """This process's slice of the ring-sharded plane array(s).

    Global layout per stored range: ring position ``p`` owns range-local
    rows ``[p*nd, (p+1)*nd)``; rows at or past the range length are padding
    (all-ones = missing, self-masking).  This process stores one
    ``[2, nd, W]`` block per local position per range, concatenated in
    (range, mesh-position) order.

    Without ``submatrix`` there is one range covering the whole cohort; with
    it, the shard's i-range (and j-range for off-diagonal shards).  The
    ingest surface (``contains`` / ``storage_offsets``) is the same either
    way, and the same as PanelStorage's.
    """

    def __init__(
        self,
        layout: PlaneLayout,
        num_samples: int,
        mesh,
        row_multiple: int = 1,
        submatrix=None,
    ):
        self.layout = layout
        self.num_samples = num_samples
        self.mesh = mesh
        self.submatrix = submatrix
        num_devices = mesh.size
        if submatrix is None:
            ranges = [(0, num_samples)]
        elif submatrix.is_diagonal:
            ranges = [(submatrix.i_begin, submatrix.num_rows)]
        else:
            ranges = [
                (submatrix.i_begin, submatrix.num_rows),
                (submatrix.j_begin, submatrix.num_cols),
            ]
        self.ranges = ranges
        # (mesh position, device) pairs owned by this process, mesh order.
        self.local_blocks = [(p, mesh.devices[p]) for p in mesh.local_positions]
        # O(1) vectorized lookups for the ingest hot path (avoid per-element
        # Python dispatch on ~10⁷-entry COO arrays).
        self._block_lut = np.full(num_devices, -1, np.int64)
        for k, (p, _) in enumerate(self.local_blocks):
            self._block_lut[p] = k
        # Per-range geometry: per-position rows (nd), local section base row.
        self._nd = []
        self._section_base = []
        base = 0
        for _, length in ranges:
            nd = -(-max(length, 1) // num_devices)
            nd = -(-nd // row_multiple) * row_multiple
            self._nd.append(nd)
            self._section_base.append(base)
            base += nd * len(self.local_blocks)
        self.planes = bitset.allocate_planes(base, layout)
        self.version = 0

    @property
    def nd(self):
        """Per-position rows: an int for single-range storage, a tuple per
        range otherwise."""
        return self._nd[0] if len(self._nd) == 1 else tuple(self._nd)

    def mark_mutated(self) -> None:
        self.version += 1

    # -- the ingest-facing surface (duck-typed like PanelStorage) ----------

    def _range_masks(self, global_idx: np.ndarray) -> list[np.ndarray]:
        out = []
        for (begin, length), nd in zip(self.ranges, self._nd):
            rel = np.asarray(global_idx) - begin
            in_range = (rel >= 0) & (rel < length)
            positions = np.clip(rel // nd, 0, len(self._block_lut) - 1)
            out.append(in_range & (self._block_lut[positions] >= 0))
        return out

    def contains(self, global_idx: np.ndarray) -> np.ndarray:
        """True for samples stored in this process (cf. cuking.cu:675-678)."""
        masks = self._range_masks(global_idx)
        result = masks[0]
        for m in masks[1:]:
            result = result | m
        return result

    def storage_offsets(self, global_idx: np.ndarray) -> np.ndarray:
        """Global sample index → row in this process's concatenated blocks;
        callers must only pass indices with ``contains(idx)`` true.

        Range selection needs only the (disjoint) global ranges — locality
        is guaranteed by the ``contains`` contract — so this does not
        re-derive the block-ownership masks on ~10⁷-entry ingest arrays."""
        global_idx = np.asarray(global_idx)
        (begin, _), nd, base = self.ranges[0], self._nd[0], self._section_base[0]
        rel = global_idx - begin
        offsets = base + self._block_lut[
            np.clip(rel // nd, 0, len(self._block_lut) - 1)
        ] * nd + rel % nd
        for (begin, length), nd, base in zip(
            self.ranges[1:], self._nd[1:], self._section_base[1:]
        ):
            rel = global_idx - begin
            # Branch-free select (np.where is ~10-30x slower than fused
            # mask arithmetic on some hosts; see PanelStorage.storage_offsets).
            in_range = ((rel >= 0) & (rel < length)).astype(offsets.dtype)
            block = self._block_lut[
                np.clip(rel // nd, 0, len(self._block_lut) - 1)
            ]
            offsets += in_range * (base + block * nd + rel % nd - offsets)
        return offsets

    # -- placement ---------------------------------------------------------

    def to_device_blocks(self) -> list[list[torch.Tensor]]:
        """One list per stored range, holding one ``[2, nd, W]`` int32
        tensor per local position, on that position's device, in mesh
        order: the input of the ring's ``*_presharded`` entries."""
        arrays = []
        for nd, base in zip(self._nd, self._section_base):
            arrays.append([
                torch.from_numpy(np.ascontiguousarray(
                    self.planes[:, base + k * nd : base + (k + 1) * nd]
                ).view(np.int32)).to(device)
                for k, (_, device) in enumerate(self.local_blocks)
            ])
        return arrays
