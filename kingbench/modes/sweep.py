"""Sweep cells: ``KingEngine.run()`` over device-resident planes.

Set-up draws the shard's genotypes on the card (``generate.py``), packs
them into the port's planes and writes them into a ``PanelStorage`` at the
storage rows that ``layout.py`` works out, builds the engine, and runs one
warm sweep, which uploads the planes.  A unit of the window is one whole
``run()``: every panel pair's count and emit launches, the hit count read
back, the rows fetched and sorted on the host.  Its output is the
``ResultSet``; the reference recomputes every pair of the shard from the
genotypes, drawn again from the seed.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from kingbench import generate
from kingbench.layout import Shard
from kingbench.reference.king import shard_rows

PACK_ROWS = 256


def rows_of(rs) -> np.ndarray:
    """A ``ResultSet`` as int64 rows (i, j, kin bits, ibs0, ibs1, ibs2)."""
    return np.stack([rs.i_idx, rs.j_idx, np.asarray(rs.kin, np.float32).view(np.uint32),
                     rs.ibs0, rs.ibs1, rs.ibs2], axis=1).astype(np.int64)


def shard_of(config: dict) -> Shard:
    return Shard(config["samples"], config["split_factor"], config["shard_index"],
                 config["panel"])


def draw(config: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    """The shard's genotypes in storage order, families planted."""
    shard = shard_of(config)
    ids = shard.sample_ids()
    codes = generate.draw_codes(seed, len(ids), config["sites"], traffic, device)
    generate.plant(codes, generate.families(traffic, shard, seed),
                   {int(g): k for k, g in enumerate(ids)}, seed)
    return codes


def reference_rows(config: dict, traffic: dict, seed: int, device,
                   dtype=torch.float32) -> np.ndarray:
    """Every pair of the shard above the threshold, from the genotypes."""
    shard = shard_of(config)
    codes = draw(config, traffic, seed, device)
    local = np.full(shard.samples, -1, np.int64)
    local[shard.sample_ids()] = np.arange(len(shard.sample_ids()))

    def get_rows(gids, lo, hi):
        return codes[torch.as_tensor(local[gids], device=codes.device), lo:hi]

    j_ids = None if shard.diagonal else np.arange(*shard.j_range)
    return shard_rows(get_rows, np.arange(*shard.i_range), j_ids, config["sites"],
                      config["kin_threshold"], dtype=dtype)


class Session:
    unit = "sweep"

    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        from cuking_tpu_torch.models.king import KingConfig, KingEngine, PanelStorage
        from cuking_tpu_torch.ops.bitset import PlaneLayout
        from cuking_tpu_torch.parallel.submatrix import Submatrix

        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.shard = shard_of(config)
        self.sites = config["sites"]
        storage = PanelStorage(
            PlaneLayout.create(self.sites),
            Submatrix.create(config["samples"], config["split_factor"], config["shard_index"]),
            config["panel"])
        if storage.planes.shape[1] != self.shard.stored_rows:
            raise ValueError(f"the port stores {storage.planes.shape[1]} rows, the layout "
                             f"{self.shard.stored_rows}")
        codes = draw(config, traffic, seed, device)
        words, rows = storage.planes.shape[2], self.shard.storage_rows()
        for lo in range(0, len(rows), PACK_ROWS):
            planes = generate.pack(codes[lo:lo + PACK_ROWS], words)
            storage.planes[:, rows[lo:lo + PACK_ROWS]] = planes.cpu().numpy().view(np.uint32)
        del codes, planes
        self.engine = KingEngine(storage, KingConfig(
            kin_threshold=config["kin_threshold"], panel=config["panel"], device=device))
        self.work = {"unique_pairs": self.shard.unique_pairs,
                     "samples": len(self.shard.sample_ids()), "sites": self.sites}

    def once(self):
        return self.engine.run()

    def ok(self, output) -> bool:
        return True

    def end_to_end(self, units: int, wall: float) -> dict:
        return {"sweep_pairs_per_s": self.shard.unique_pairs * units / wall}

    def layer_context(self, outputs: list) -> dict:
        return {"work": self.work}

    def notes(self, outputs: list) -> str:
        return ""

    def free(self) -> None:
        self.engine = None
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def reference(self) -> np.ndarray:
        return reference_rows(self.config, self.traffic, self.seed, self.device)

    def outputs_rows(self, outputs: list) -> list:
        return [rows_of(rs) for rs in outputs]

    def close(self) -> None:
        pass
