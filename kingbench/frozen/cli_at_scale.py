"""Frozen copy of parts of ``tools/torch_cli_at_scale.py`` as of commit
a4f2d36: the family layout of ``Cohort.special_rows`` and
``Cohort.families``, and ``stage_seconds`` and ``read_output``.

Adapted: the layout takes the shard as :class:`kingbench.layout.Shard`
(the tool asks the port's ``Submatrix``) and the family sizes as an
argument (the tool's ``FAMILY_SIZES`` cycle); ``read_output`` lists the
partitions itself instead of through the port's ``Storage``, and returns
rows as an array; ``check`` raises ValueError.  The tool's genotype draw
(splitmix64 on the host) is not copied: the benchmark draws on the card
(``kingbench/generate.py``).
"""

from __future__ import annotations

import os
import re

import numpy as np


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"check failed: {msg}")


def special_rows(shard, panel: int) -> list[int]:
    """The rows planted first: the clone pair, then the half-copy
    family's edges.  At split 1 rows 0 / N - 1 and the panel edges
    1,023 / 1,024 and 2,047 / 2,048.  For a shard: its first i-row and
    last j-row; then its second i-row, the i section's panel edges and
    last row, a row of another block, and the j section's first two
    rows, panel edges and its last panel's first row and the row
    before it."""
    n = shard.samples
    if shard.split_factor == 1:
        rows = [0, n - 1, panel - 1, panel, 2 * panel - 1, 2 * panel]
    else:
        (i_begin, i_end), (j_begin, j_end) = shard.i_range, shard.j_range
        num_cols = j_end - j_begin
        j_last = j_begin + (num_cols - 1) // panel * panel
        other = (i_end if i_end < j_begin
                 else j_end if j_end < n else i_begin - 1)
        rows = [i_begin, j_end - 1,
                i_begin + 1, i_begin + panel - 1, i_begin + panel, i_end - 1, other,
                j_begin, j_begin + 1, j_begin + panel - 1, j_begin + panel,
                j_last - 1, j_last]
    return [r for r in dict.fromkeys(rows) if 0 <= r < n]


def family_rows(sizes: list[int], special: list[int], pool: np.ndarray,
                rng: np.random.Generator) -> list[np.ndarray]:
    """The rows of each family of ``sizes``, the first its source: the
    special rows first, in order, then rows of ``pool`` drawn by ``rng``.
    No row is in two families."""
    eligible = set(pool.tolist())
    special = [r for r in special if r in eligible]
    rest = np.setdiff1d(pool, special)
    check(sum(sizes) <= len(pool), f"{sum(sizes)} planted rows > {len(pool)} samples")
    order = rng.permutation(rest)
    rows = np.concatenate([special, order[:max(0, sum(sizes) - len(special))]]).astype(np.int64)
    out, k = [], 0
    for m in sizes:
        out.append(rows[k:k + m])
        k += m
    return out


_STAGES = {
    "metadata": "Reading metadata",
    "allocate": "Allocating bit planes",
    "listing": "Listing input files",
    "ingest": "Processing Parquet tables",
    "king_kernel": "Running KING kernel for",
    "write": "Writing",
}


def stage_seconds(log: str) -> dict:
    """Each stage of the CLI's log, ``<message>...<dots> (<seconds>s)``."""
    out = {}
    for stage, message in _STAGES.items():
        m = re.search(re.escape(message) + r"[^\n]*?\.\.\.\.*\s*\(([0-9.]+)s\)", log)
        check(m is not None, f"no '{message}' stage in the task's log")
        out[stage] = float(m.group(1))
    return out


def read_output(output_dir: str) -> np.ndarray:
    """The CLI's output partitions as int64 rows (i, j, kin bits, ibs0,
    ibs1, ibs2), sample IDs ``S<index>`` mapped back to indices, in the
    order written."""
    import pyarrow.parquet as pq

    parts = []
    for name in sorted(os.listdir(output_dir)):
        if not name.endswith(".parquet"):
            continue
        t = pq.read_table(os.path.join(output_dir, name))
        i = [int(s[1:]) for s in t.column("i").to_pylist()]
        j = [int(s[1:]) for s in t.column("j").to_pylist()]
        kin = np.asarray(t.column("kin").to_numpy(), np.float32).view(np.uint32)
        ibs = [t.column(c).to_numpy() for c in ("ibs0", "ibs1", "ibs2")]
        parts.append(np.stack([np.asarray(i), np.asarray(j), kin, *ibs], axis=1).astype(np.int64))
    return np.concatenate(parts) if parts else np.zeros((0, 6), np.int64)
