"""Export cells: whole keep-all tasks, ``cuking_tpu_torch.cli.main(argv)``
with ``--keep_all``, every pair of the shard written as ``hl.king`` gives
the whole kinship matrix.

The task mode's session (``modes/task.py``), extended: set-up draws the
cohort and writes its Parquet as there, and a unit of the window is one
task, but its arguments are the configuration's split and shard and
``--keep_all``, with no threshold.  Before drawing anything the session
checks that the port's parser knows ``--keep_all``, and raises RuntimeError
when it does not, so a port without it stops at once.  The reference keeps
every pair (``reference/every_pair.py``) and must hold exactly the shard's
unique pairs, so a reference that drops pairs cannot pass.  The partitions
are read back after the window one at a time, sample IDs mapped to indices
by Arrow's compute functions (5.1M rows a partition).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from kingbench.modes import task
from kingbench.modes.sweep import shard_of
from kingbench.reference.every_pair import shard_rows_all


def reference_rows(config: dict, traffic: dict, seed: int, device,
                   dtype=torch.float32) -> np.ndarray:
    """Every pair of the shard, whatever its kin, from the genotypes; exactly
    the shard's unique pairs, or ValueError."""
    shard = shard_of(config)
    codes = task.draw(config, traffic, seed, device)

    def get_rows(gids, lo, hi):
        return codes[torch.as_tensor(gids, device=codes.device), lo:hi]

    j_ids = None if shard.diagonal else np.arange(*shard.j_range)
    rows = shard_rows_all(get_rows, np.arange(*shard.i_range), j_ids, codes.shape[1],
                          dtype=dtype)
    if len(rows) != shard.unique_pairs:
        raise ValueError(f"the reference holds {len(rows)} rows, the shard "
                         f"{shard.unique_pairs} pairs")
    return rows


def keep_all_known() -> bool:
    """Whether the port's CLI parser knows ``--keep_all``."""
    from cuking_tpu_torch import cli

    _, unknown = cli.build_parser().parse_known_args(["--keep_all"])
    return not unknown


def read_rows(output_dir: str) -> np.ndarray:
    """The CLI's output partitions as int64 rows (i, j, kin bits, ibs0,
    ibs1, ibs2), sample IDs ``S<index>`` mapped back to indices, in the
    order written."""
    import pyarrow as pa
    import pyarrow.compute as pc
    import pyarrow.parquet as pq

    parts = []
    for name in sorted(os.listdir(output_dir)):
        if not name.endswith(".parquet"):
            continue
        t = pq.read_table(os.path.join(output_dir, name))
        ids = [pc.cast(pc.utf8_slice_codeunits(t.column(c), 1), pa.int64()).to_numpy()
               for c in ("i", "j")]
        kin = np.asarray(t.column("kin").to_numpy(), np.float32).view(np.uint32)
        ibs = [t.column(c).to_numpy() for c in ("ibs0", "ibs1", "ibs2")]
        parts.append(np.stack([*ids, kin, *ibs], axis=1).astype(np.int64))
    return np.concatenate(parts) if parts else np.zeros((0, 6), np.int64)


class Session(task.Session):
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        if not keep_all_known():
            raise RuntimeError("the port's CLI has no --keep_all: it cannot run an "
                               "export cell")
        # The task session's set-up, its threshold argument swapped for
        # --keep_all (the placeholder threshold never reaches the port).
        super().__init__({**config, "kin_threshold": 0.0}, traffic, seed, device)
        self.config, self.shard = config, shard_of(config)
        at = self.argv.index("--kin_threshold")
        self.argv[at:at + 2] = ["--keep_all"]

    def layer_context(self, outputs: list) -> dict:
        return {**super().layer_context(outputs),
                "work": {"unique_pairs": self.shard.unique_pairs}}

    def reference(self) -> np.ndarray:
        return reference_rows(self.config, self.traffic, self.seed, self.device)

    def outputs_rows(self, outputs: list):
        """Each output's rows, read when the comparison reaches it."""
        dirs = [o.out_dir if o.rc == 0 else None for o in outputs]
        return (read_rows(d) if d is not None else None for d in dirs)
