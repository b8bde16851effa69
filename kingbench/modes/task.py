"""Task cells: whole fan-out tasks, ``cuking_tpu_torch.cli.main(argv)``.

Set-up draws the cohort's genotypes at the traffic's written sites on the
card (``generate.py``), keeps them on the host, writes them as a Hail
export's Parquet under ``TMPDIR`` with ``metadata.json`` naming every site
of the configuration, and runs one warm task.  A unit of the window is one
task in this process, with the CLI's defaults but for the configuration's
threshold and shard: metadata, allocation, listing, ingest, the engine
(upload, sweep, count read, fetch and sort) and the writer, into a fresh
output directory.  Its standard output, the CLI's stage log, is captured
line by line with the host clock.  After each task the harness drops
PyTorch's cached device memory, so the next task starts as a fresh process
would.  The output is the partition read back, sample IDs mapped to
indices; the reference recomputes every pair of the shard from the kept
genotypes (a site that is not written is missing for every sample, so it
counts for no pair).
"""

from __future__ import annotations

import contextlib
import gc
import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from kingbench import generate
from kingbench.frozen.cli_at_scale import read_output, stage_seconds
from kingbench.layout import Shard
from kingbench.reference.king import shard_rows


class StampedStream:
    """A text stream that keeps what is written, each write with the host
    clock at which it came."""

    def __init__(self):
        self.writes: list[tuple[float, str]] = []

    def write(self, text: str) -> int:
        self.writes.append((time.perf_counter(), text))
        return len(text)

    def flush(self) -> None:
        pass

    def getvalue(self) -> str:
        return "".join(t for _, t in self.writes)


@dataclass
class TaskOutput:
    rc: int
    out_dir: str
    log: StampedStream = field(repr=False)


STAGE_MESSAGES = {
    "Reading metadata": "metadata", "Allocating bit planes": "allocate",
    "Listing input files": "listing", "Processing Parquet tables": "ingest",
    "Running KING kernel": "king_kernel", "Writing": "write",
}


def stage_spans(log: StampedStream) -> list[tuple[float, float, str]]:
    """(begin, end, stage) on the host clock of each stage of a task's log:
    a stage begins with its message and ends with its ``(<s>s)``."""
    spans, begun = [], None
    for t, text in log.writes:
        if begun is None:
            stage = next((v for k, v in STAGE_MESSAGES.items() if text.startswith(k)), None)
            if stage is not None and text.rstrip().endswith("..."):
                begun = (t, stage)
        elif text.startswith(" (") and text.rstrip().endswith("s)"):
            spans.append((begun[0], t, begun[1]))
            begun = None
    return spans


def draw(config: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    """The cohort's genotypes at the written sites, families planted."""
    shard = Shard(config["samples"], config["split_factor"], config["shard_index"],
                  config["panel"])
    codes = generate.draw_codes(seed, config["samples"], traffic["written_sites"], traffic,
                                device)
    generate.plant(codes, generate.families(traffic, shard, seed), None, seed)
    return codes


def reference_rows(config: dict, traffic: dict, seed: int, device,
                   dtype=torch.float32) -> np.ndarray:
    """Every pair of the shard above the threshold, from the genotypes (a
    site that is not written is missing for every sample, so it counts for
    no pair)."""
    shard = Shard(config["samples"], config["split_factor"], config["shard_index"],
                  config["panel"])
    codes = draw(config, traffic, seed, device)

    def get_rows(gids, lo, hi):
        return codes[torch.as_tensor(gids, device=codes.device), lo:hi]

    j_ids = None if shard.diagonal else np.arange(*shard.j_range)
    return shard_rows(get_rows, np.arange(*shard.i_range), j_ids, codes.shape[1],
                      config["kin_threshold"], dtype=dtype)


class Session:
    unit = "task"

    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.tmp = tempfile.mkdtemp(prefix="kingbench-")
        codes = draw(config, traffic, seed, device).cpu().numpy()
        input_dir = os.path.join(self.tmp, "input")
        self.input = generate.write_input(codes, config["sites"], input_dir,
                                          traffic["sites_per_file"], os.cpu_count() or 1)
        self.argv = ["--input_uri", input_dir, "--kin_threshold", repr(config["kin_threshold"]),
                     "--split_factor", str(config["split_factor"]),
                     "--shard_index", str(config["shard_index"]), "--device", device]
        self.tasks = 0

    def once(self) -> TaskOutput:
        from cuking_tpu_torch import cli

        out_dir = os.path.join(self.tmp, f"out-{self.tasks:05d}")
        self.tasks += 1
        log = StampedStream()
        with contextlib.redirect_stdout(log):
            rc = cli.main(self.argv + ["--output_uri", out_dir])
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        return TaskOutput(rc, out_dir, log)

    def ok(self, output: TaskOutput) -> bool:
        return output.rc == 0

    def end_to_end(self, units: int, wall: float) -> dict:
        return {"task_s": wall / units}

    def layer_context(self, outputs: list) -> dict:
        done = [o for o in outputs if o.rc == 0]
        return {"stages": [stage_seconds(o.log.getvalue()) for o in done],
                "stage_spans": [stage_spans(o.log) for o in outputs],
                "entries": self.input["entries"]}

    def notes(self, outputs: list) -> str:
        """Each task's stages, for the run's log."""
        return "; ".join(" ".join(f"{k} {v:.3f}" for k, v in stage_seconds(o.log.getvalue()).items())
                         for o in outputs if o.rc == 0)

    def free(self) -> None:
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def reference(self) -> np.ndarray:
        return reference_rows(self.config, self.traffic, self.seed, self.device)

    def outputs_rows(self, outputs: list) -> list:
        return [read_output(o.out_dir) if o.rc == 0 else None for o in outputs]

    def close(self) -> None:
        shutil.rmtree(self.tmp, ignore_errors=True)
