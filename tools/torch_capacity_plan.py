#!/usr/bin/env python3
"""Cohort plan for the PyTorch/CUDA port: share-nothing single-H100 tasks.

The twin of ``tools/capacity_plan.py``, which plans a TPU pod slice.  The
port deploys one H100 per Cloud Batch task (``cuking_tpu_torch/cloud/
batch_submit.py``), one task per ``--split_factor`` shard, so the plan is:

* the smallest ``--split_factor`` whose worst shard passes the CLI's own
  memory check, ``utils/hbm.check_engine_fit``, at the default
  ``KingConfig`` (capacity, ``max_results``, panel 1024, words multiple 4),
  with the limit that check computes in a task: the free device memory a
  fresh process sees (the card's total less its CUDA context) times
  ``_USABLE_FRACTION``;
* the number of tasks, k(k+1)/2;
* the GPU-hours per cohort: per task, the entries it ingests (every task
  reads the whole input) over the ingest rate, plus its panel-pair steps
  times the time per 1024 x 1024 step at the cohort's word count, plus the
  task's time outside both (start-up, plane allocation and upload, sort
  and write).

The rates are flags.  Their defaults are readings on an NVIDIA
H100 80GB HBM3 at 700.00 W: 1.11 ms per step at 3,128 words (the count
kernel alone, ``chip_smoke.py`` phase 2) and 10.55 ms at 31,252 words (a
whole 69,632 x 1,000,000 sweep, 24.755 s over 2,346 steps, diagonal steps
and emit launches included; phase 13a), interpolated linearly in words;
ingest and the time outside ingest and the sweep from one whole CLI task
of 150,000 x 1,000,000 from Parquet (cell O, ``tools/torch_cli_at_scale.py``)
on the H100 host's 8 CPUs.

    python3 tools/torch_capacity_plan.py --samples 150000 --sites 1000000

The plan against a task that ran it: for 730,947 x 1,000,000 the plan
gives split 5 and a worst shard of 73,220,685,824 B of planes (blocks (0,
1), both full) against a limit of 77,707,883,315 B.  Shard 4 = blocks (0,
4), whose last block holds 3 samples fewer, stores as many rows (each
section pads to 146,432), and its CLI task on an NVIDIA H100 80GB HBM3 at
700.00 W (cell R, ``tools/torch_cli_at_scale.py --split-factor 5
--shard-index 4``) read in ``check_engine_fit`` the plan's free memory to
the byte (84,465,090,560 B of 85,017,493,504 B) and so the same limit; its
model of the shard was 73,740,779,520 B and its peak device memory
73,296,183,808 B, 424.0 MiB under the model and 4.41 GB under the limit.
Its peak host RSS was 80,465 MiB (sampled every 50 ms), 10,637 MiB beside
the planes on 8 decoders, inside ``cloud/batch_submit.py``'s 107,520 MiB
request; the plan models no host memory.  Its time outside ingest and the
sweep was ~66 s (allocation 45.6 s, upload 11.7 s, ~8 s of start-up)
against ``STARTUP_S``'s 36, and its ingest read 71.8M entries/s (it keeps
40% of them) against ``INGEST_ENTRIES_PER_S``'s 21.8M, a split-1 reading.

Prints the plan and one JSON line last.  Exits 1 when no split factor fits.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100 80GB
# HBM3 (power limit 700.00 W), read on the card, and the free memory
# (torch.cuda.mem_get_info) that a fresh process sees there once it has made
# its CUDA context, which check_engine_fit reads in a task
# (tools/torch_shard_at_scale.py).
H100_TOTAL_MEMORY = 85_017_493_504
H100_FREE_MEMORY = 84_465_090_560
# ms per 1024 x 1024 panel-pair step of the count kernel, at (words, ms).
STEP_MS_AT = ((3_128, 1.11), (31_252, 10.55))
# Cell O's task outside ingest and the sweep: 35.1 / 37.5 s in two runs
# (start-up ~11.7 s, allocating 37.63 GB of planes 18.8-19.1 s, uploading
# them 5.6-6.0 s, sort and write < 1 s); the allocation and upload grow
# with the shard.
STARTUP_S = 36.0
# Entries/s of cell O's ingest alone on all 8 CPUs of the H100 host (the
# 26-CPU pin of a3-highgpu-1g cannot be taken there): the median of three
# whole-input runs, 21.35-24.60M; the task's own ingest stage in the same
# run read 33.1M/s, and 4 CPUs gave 15.9M/s over 48 files.
INGEST_ENTRIES_PER_S = 21.8e6
# Parquet entries (defined genotypes) per sample and site: 5% missing.
ENTRY_DENSITY = 0.95


def step_ms(words: int, at=STEP_MS_AT) -> float:
    """ms per 1024 x 1024 step at ``words`` words per plane row, linear in
    words through the two readings."""
    (w0, t0), (w1, t1) = at
    return t0 + (words - w0) * (t1 - t0) / (w1 - w0)


def worst_shard(num_samples: int, split_factor: int):
    """The shard that stores the most rows: the one diagonal shard at k = 1,
    else the off-diagonal shard of blocks 0 and 1, both full."""
    from cuking_tpu_torch.parallel.submatrix import Submatrix

    return Submatrix.create(num_samples, split_factor, 0 if split_factor == 1 else 1)


def fits(num_samples: int, words: int, split_factor: int, bytes_limit: int, config) -> bool:
    """Whether the worst shard at ``split_factor`` passes check_engine_fit."""
    from cuking_tpu_torch.utils.hbm import check_engine_fit
    from cuking_tpu_torch.utils.status import InvalidArgumentError

    try:
        check_engine_fit(num_samples, words, worst_shard(num_samples, split_factor),
                         config, split_factor, bytes_limit=bytes_limit)
    except InvalidArgumentError:
        return False
    return True


def minimal_split_factor(num_samples: int, words: int, bytes_limit: int, config):
    """The smallest split factor whose worst shard fits, or None when even
    one sample per block does not (the result buffers alone overflow)."""
    if fits(num_samples, words, 1, bytes_limit, config):
        return 1
    if not fits(num_samples, words, num_samples, bytes_limit, config):
        return None
    # From k = 2 on, the worst shard holds two blocks of ceil(N / k) rows,
    # which shrink as k grows; k = 1's one block may be smaller than k = 2's
    # two, so it is tried alone above.
    lo, hi = 1, num_samples
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if fits(num_samples, words, mid, bytes_limit, config):
            hi = mid
        else:
            lo = mid
    return hi


def largest_diagonal_rows(words: int, bytes_limit: int, config) -> int:
    """The most rows, a multiple of ``config.panel``, of a split-1 shard
    that check_engine_fit admits under ``bytes_limit``; 0 when not one
    panel fits."""
    panel = config.panel
    # fits(lo * panel) (or lo == 0); not fits(hi * panel): a panel of planes
    # is at least 2 * panel * words * 4 bytes.
    lo, hi = 0, bytes_limit // (8 * panel * words) + 1
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if fits(mid * panel, words, 1, bytes_limit, config):
            lo = mid
        else:
            hi = mid
    return lo * panel


def shard_steps(num_samples: int, split_factor: int, panel: int) -> list[int]:
    """Panel-pair steps of every shard: P(P+1)/2 for a diagonal shard of P
    panels, P_i x P_j off the diagonal."""
    from cuking_tpu_torch.parallel.submatrix import Submatrix, num_shards

    steps = []
    for idx in range(num_shards(split_factor)):
        sm = Submatrix.create(num_samples, split_factor, idx)
        pi, pj = -(-sm.num_rows // panel), -(-sm.num_cols // panel)
        steps.append(pi * (pi + 1) // 2 if sm.is_diagonal else pi * pj)
    return steps


def build_plan(num_samples: int, num_sites: int, *, free_bytes: int = H100_FREE_MEMORY,
               step_ms_at=STEP_MS_AT, startup_s: float = STARTUP_S,
               ingest_rate: float = INGEST_ENTRIES_PER_S,
               density: float = ENTRY_DENSITY) -> dict:
    from cuking_tpu_torch.models.king import KingConfig
    from cuking_tpu_torch.ops.bitset import PlaneLayout
    from cuking_tpu_torch.utils.hbm import _USABLE_FRACTION, engine_plane_bytes

    config = KingConfig()
    words = PlaneLayout.create(num_sites).words
    limit = int(free_bytes * _USABLE_FRACTION)
    k = minimal_split_factor(num_samples, words, limit, config)
    plan = {
        "samples": num_samples, "sites": num_sites, "words": words,
        "free_bytes": free_bytes, "usable_bytes": limit, "split_factor": k,
    }
    if k is None:
        return plan
    steps = shard_steps(num_samples, k, config.panel)
    ms = step_ms(words, step_ms_at)
    ingest_s = density * num_samples * num_sites / ingest_rate
    task_s = [ingest_s + n * ms / 1e3 + startup_s for n in steps]
    plan.update(
        tasks=len(steps),
        worst_shard_plane_bytes=engine_plane_bytes(
            worst_shard(num_samples, k), words, config.panel),
        steps=sum(steps),
        step_ms=ms,
        task_hours={"ingest": ingest_s / 3600, "max": max(task_s) / 3600},
        gpu_hours={
            "ingest": len(steps) * ingest_s / 3600,
            "sweep": sum(steps) * ms / 3.6e6,
            "startup": len(steps) * startup_s / 3600,
            "total": sum(task_s) / 3600,
        },
        rates={"step_ms_at_words": [list(p) for p in step_ms_at], "startup_s": startup_s,
               "ingest_entries_per_s": ingest_rate, "entries_per_sample_site": density,
               "source": "readings on an NVIDIA H100 80GB HBM3, 700.00 W: "
                         "steps by chip_smoke.py, ingest and the rest of a task by "
                         "tools/torch_cli_at_scale.py on the host's 8 CPUs"},
    )
    return plan


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--samples", type=int, default=150_000)
    ap.add_argument("--sites", type=int, default=1_000_000)
    ap.add_argument("--bytes", type=int, default=H100_FREE_MEMORY, help=(
        "the device memory a task's process finds free, in bytes, before the "
        "usable fraction (default: read on an NVIDIA H100 80GB HBM3, 700.00 W, "
        "whose total is 85,017,493,504 B)"))
    ap.add_argument("--step-ms-100k", type=float, default=STEP_MS_AT[0][1], help=(
        "ms per 1024 x 1024 step at 3,128 words (100,000 sites); default: the count "
        "kernel on an NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py phase 2)"))
    ap.add_argument("--step-ms-1m", type=float, default=STEP_MS_AT[1][1], help=(
        "the same at 31,252 words (1,000,000 sites); default: a whole 69,632-sample "
        "sweep per step on an NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py phase 13a)"))
    ap.add_argument("--startup-s", type=float, default=STARTUP_S, help=(
        "seconds per task outside ingest and the sweep; default: a whole "
        "150,000 x 1,000,000 task on an NVIDIA H100 80GB HBM3, 700.00 W "
        "(tools/torch_cli_at_scale.py)"))
    ap.add_argument("--ingest-rate", type=float, default=INGEST_ENTRIES_PER_S, help=(
        "Parquet entries read per second; default: the median of three whole-input "
        "ingests of a 150,000 x 1,000,000 task on the H100 host's 8 CPUs "
        "(tools/torch_cli_at_scale.py)"))
    ap.add_argument("--density", type=float, default=ENTRY_DENSITY, help=(
        "Parquet entries per sample and site (1 - the missing rate)"))
    args = ap.parse_args(argv)

    plan = build_plan(
        args.samples, args.sites, free_bytes=args.bytes,
        step_ms_at=((STEP_MS_AT[0][0], args.step_ms_100k),
                    (STEP_MS_AT[1][0], args.step_ms_1m)),
        startup_s=args.startup_s, ingest_rate=args.ingest_rate, density=args.density)
    gib = 2 ** 30
    if plan["split_factor"] is None:
        print(f"{args.samples:,} samples x {args.sites:,} sites fit no split factor on "
              f"{plan['usable_bytes'] / gib:.2f} GiB: the result buffers alone do not "
              "fit.", file=sys.stderr)
        print(json.dumps(plan))
        return 1
    hours = plan["gpu_hours"]
    print(
        f"Plan: {args.samples:,} samples x {args.sites:,} sites ({plan['words']} words "
        f"per plane row), one H100 per task\n"
        f"  --split_factor {plan['split_factor']}: {plan['tasks']} task(s); the worst "
        f"shard holds {plan['worst_shard_plane_bytes'] / gib:.2f} GiB of planes of "
        f"{plan['usable_bytes'] / gib:.2f} GiB usable\n"
        f"  {plan['steps']:,} panel-pair steps at {plan['step_ms']:.3f} ms\n"
        f"  GPU-hours per cohort: {hours['total']:.2f} (ingest {hours['ingest']:.2f}, "
        f"sweep {hours['sweep']:.2f}, the rest {hours['startup']:.2f}); the longest "
        f"task {plan['task_hours']['max']:.2f} h\n"
        "  The rates are readings on an NVIDIA H100 80GB HBM3 at 700.00 W; "
        "ingest and the rest of a task are one whole 150,000 x 1,000,000 task's on "
        "the host's 8 CPUs (tools/torch_cli_at_scale.py), not a 26-vCPU task's.",
        file=sys.stderr,
    )
    print(json.dumps(plan))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    raise SystemExit(main())
