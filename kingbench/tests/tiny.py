"""Tiny cells for the CPU tests: the real cells' traffic, at sizes a test
run holds."""

from __future__ import annotations

from kingbench import run

MANIFEST = run.load_json(run.REPO, "BENCHMARK.json")
SEED = 2**31 + 11

FAMILIES = [{"size": 2, "degree": 0, "count": 1}, {"size": 16, "degree": 1, "count": 1},
            {"size": 2, "degree": 0, "count": 4}, {"size": 3, "degree": 1, "count": 2},
            {"size": 2, "degree": 3, "count": 4}]


def spec(mode: str, split: int = 5, shard: int = 4, samples: int = 600, sites: int = 2000):
    """(cell name, (cell, configuration, traffic)) of a tiny cell."""
    name = f"gnomad_v4.{mode}"
    config = {"samples": samples, "sites": sites, "split_factor": split, "shard_index": shard,
              "kin_threshold": 0.05, "panel": 128}
    traffic = run.load_json(run.HERE, "workloads", f"{name}.json")
    traffic["families"] = FAMILIES
    if mode == "task":
        traffic.update(written_sites=sites, sites_per_file=700)
    cell = next(w for w in MANIFEST["workloads"] if w["name"] == name)
    return name, (cell, config, traffic)


def run_tiny(mode: str, trace: bool = False, seconds: float = 0.2, **kw) -> dict:
    name, sp = spec(mode, **kw)
    return run.run_cell(MANIFEST, name, SEED, seconds, trace, device="cpu", spec=sp)
