#!/usr/bin/env python3
"""Weak scaling of the PyTorch/CUDA port's ring over cards: pairs/s per GPU
against the number of ring positions D (BASELINE.md's target: at least 85%
efficiency at D >= 2).

The twin of ``tools/scaling_bench.py``, which measures the JAX package.
It sweeps the production ring path, ``parallel.ring.all_pairs_presharded``
with the CUDA count kernel's indexed entry (what ``--use_mesh`` and
``--distributed`` run): the rows per position stay constant, the cohort
grows with D and the pair work with ~D^2/2, so ideal pairs/s per GPU is
flat.  Per D it reports the median of 3 timed sweeps (host clock, ending in
``torch.cuda.synchronize()`` on every card) with their min and max, pairs/s
per GPU, the efficiency against D = 1, the ring's steps and sub-tiles
(the count entry's calls in one sweep, held to ``ring_schedule``'s) and the
hits.

Planted hits, as in the JAX tool: on cards, random packed words with 32
clone families of 4 in the first block and row 0 cloned into the last row
(32 x 6 + 4 = 196 hits at threshold 0.4 at every D); on the CPU, genuine
genotypes with 8 families (52 hits).  A hit count other than the expected
one exits 1.

- One position per card (the default on cards): at the largest D >= 2 one
  sweep runs under ``torch.profiler``, and the share of peer-copy and NCCL
  time that lies under count-kernel time on the same card is reported
  (the twin of ``tools/trace_report.ppermute_overlap``).  Exits 1 when a
  D >= 2 falls under ``--min-efficiency`` unless ``--no-assert``.
- ``--same-card``: every position on ``cuda:0``.  This checks the schedule
  at full size (identical hit totals across D, sub-tiles as scheduled) and
  reports no efficiency: the positions share one card.
- ``--device cpu``: validates the schedule, not time, at small sizes.

Without a card it exits 2 unless ``--device cpu`` is given.

    python3 tools/torch_scaling_bench.py                   # one position per card
    python3 tools/torch_scaling_bench.py --same-card --devices 1 2 3 4
    python3 tools/torch_scaling_bench.py --device cpu

Prints the card's name and power limit and torch's version, one line per D
on stderr, and one JSON line last (``weak_scaling``, ``overlap``,
``target_efficiency``, ``device``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

THRESHOLD = 0.4  # clones (kin 0.5) pass; unrelated random pairs do not
GPU_FAMILIES, CPU_FAMILIES, FAMILY_SIZE = 32, 8, 4
CAPACITY = 1 << 16
COUNT_KERNEL = "king_counts_wgmma_kernel"


def expected_hits(families: int) -> int:
    """The clone families' pairs, plus the 4 of row 0's clone in the last
    row (row 0's family is rows 0-3)."""
    return families * FAMILY_SIZE * (FAMILY_SIZE - 1) // 2 + FAMILY_SIZE


def plant_families(rows: np.ndarray, families: int) -> None:
    """Clones row ``4f`` into rows ``4f+1 .. 4f+3`` for each family f, in
    place (rows are indexed on the first axis)."""
    for fam in range(families):
        src = fam * FAMILY_SIZE
        for m in range(1, FAMILY_SIZE):
            rows[src + m] = rows[src]


def cohort_planes(max_rows: int, sites: int, on_card: bool) -> tuple[np.ndarray, int]:
    """[2, max_rows, W] uint32 planes with the planted families, and the
    hits expected at every D."""
    from cuking_tpu_torch.ops.bitset import PlaneLayout, pack_genotypes
    from cuking_tpu_torch.utils.synthetic import random_genotypes, random_planes

    layout = PlaneLayout.create(sites)
    if on_card:
        planes = random_planes(max_rows, layout, np.random.default_rng(0))
        plant_families(planes.transpose(1, 0, 2), GPU_FAMILIES)
        return planes, expected_hits(GPU_FAMILIES)
    g = random_genotypes(max_rows, sites, missing_rate=0.05, seed=1, num_related_pairs=0)
    plant_families(g, CPU_FAMILIES)
    return pack_genotypes(g, layout), expected_hits(CPU_FAMILIES)


def schedule_sub_tiles(num_devices: int, ns: int) -> int:
    """Sub-tiles of one sweep by ``ring_schedule``, with ``ns`` sub-panels
    per block: a position's triangle at step 0, a whole ns x ns grid at a
    full step, and half of it at the even-D wrap step (one sub-tile split
    inside when ns == 1)."""
    from cuking_tpu_torch.parallel.ring import ring_schedule

    total = 0.0
    for _, t, _, frac in ring_schedule(num_devices):
        total += ns * (ns + 1) // 2 if t == 0 else (1 if ns == 1 else frac * ns * ns)
    return int(total)


def covered_share(intervals: list) -> dict | None:
    """The share of transfer time under count-kernel time on the same card.
    ``intervals`` holds (card, kind, start, end) with kind "transfer" or
    "kernel"; a transfer counts as covered only by its own card's kernels.
    None when there is no transfer."""
    total = covered = events = 0.0
    for card in {c for c, *_ in intervals}:
        transfers = sorted((s, e) for c, k, s, e in intervals if c == card and k == "transfer")
        kernels = sorted((s, e) for c, k, s, e in intervals if c == card and k == "kernel")
        merged: list = []
        for s, e in kernels:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        events += len(transfers)
        for s, e in transfers:
            total += e - s
            covered += sum(max(0.0, min(e, ke) - max(s, ks)) for ks, ke in merged)
    if not events:
        return None
    return {"transfer_ms": total / 1e3, "covered_ms": covered / 1e3,
            "overlap_fraction": covered / total if total else 1.0,
            "num_transfers": int(events)}


def profiled_intervals(prof) -> list:
    """(card, kind, start us, end us) of a torch.profiler run's device
    events: peer copies and NCCL kernels as transfers, the count kernel as
    kernels."""
    import torch

    out = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "Memcpy PtoP" in e.name or e.name.startswith("nccl"):
            kind = "transfer"
        elif COUNT_KERNEL in e.name:
            kind = "kernel"
        else:
            continue
        out.append((e.device_index, kind, e.time_range.start, e.time_range.end))
    return out


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows-per-gpu", type=int, default=None,
                    help="resident samples per ring position (default 16384 on "
                         "cards, 64 on the CPU)")
    ap.add_argument("--sites", type=int, default=None,
                    help="default 100000 on cards, 2000 on the CPU")
    ap.add_argument("--devices", type=int, nargs="*", default=None,
                    help="ring sizes D to sweep (default 1 .. the number of cards; "
                         "1 2 3 4 with --same-card or on the CPU)")
    ap.add_argument("--same-card", action="store_true",
                    help="every position on cuda:0: checks the schedule, no efficiency")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--min-efficiency", type=float, default=0.85)
    ap.add_argument("--no-assert", action="store_true")
    args = ap.parse_args(argv)

    import torch

    from cuking_tpu_torch.ops.king_cuda import panel_counts_cuda, panel_counts_cuda_indexed
    from cuking_tpu_torch.parallel.ring import (
        RingMesh, all_pairs_presharded, ring_global_counts, ring_num_steps,
    )

    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        print("torch_scaling_bench: no CUDA device; pass --device cpu to validate the "
              "schedule on the plain path", file=sys.stderr)
        return 2
    cards = torch.cuda.device_count() if on_card else 0
    per_card = on_card and not args.same_card
    rows = args.rows_per_gpu or (16384 if on_card else 64)
    sites = args.sites or (100_000 if on_card else 2_000)
    sub_panel = 1024 if on_card else 32
    if rows % sub_panel:
        print(f"torch_scaling_bench: --rows-per-gpu must be a multiple of {sub_panel}",
              file=sys.stderr)
        return 2
    wanted = args.devices or (list(range(1, cards + 1)) if per_card else [1, 2, 3, 4])
    ds = sorted({d for d in wanted if d >= 1 and (d <= cards or not per_card)})
    if not ds:
        print(f"torch_scaling_bench: no requested D is available: asked for {wanted}, "
              f"have {cards} card(s)", file=sys.stderr)
        return 1
    device = {"platform": "gpu" if on_card else "cpu", "count": cards,
              "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
              "card": card_line() if on_card else None, "torch": torch.__version__,
              "positions": ("one per card" if per_card else
                            "all on cuda:0" if on_card else "cpu")}
    print(f"{device['card'] or 'no card (cpu)'}; torch {torch.__version__}; positions "
          f"{device['positions']}", file=sys.stderr)

    planes_all, expected = cohort_planes(rows * max(ds), sites, on_card)
    calls = [0]

    def counted(*a, **kw):
        calls[0] += 1
        return panel_counts_cuda_indexed(*a, **kw)

    def sync() -> None:
        for k in range(cards):
            torch.cuda.synchronize(k)

    def placement(d: int) -> list:
        if per_card:
            return [f"cuda:{k}" for k in range(d)]
        return ["cuda:0" if on_card else "cpu"] * d

    def setup(d: int):
        n = rows * d
        planes = planes_all[:, :n].copy()
        planes[:, n - 1] = planes[:, 0]  # related pairs span the first and last blocks
        mesh = RingMesh(placement(d))
        blocks = [torch.from_numpy(np.ascontiguousarray(
            planes[:, p * rows:(p + 1) * rows]).view(np.int32)).to(mesh.devices[p])
            for p in range(d)]
        return mesh, blocks, n

    def sweep(mesh, blocks, n, threshold):
        out = all_pairs_presharded(blocks, n, mesh, panel_counts_cuda,
                                   kin_threshold=threshold, capacity_per_device=CAPACITY,
                                   sub_panel=sub_panel, indexed_kernel=counted)
        sync()
        return int(ring_global_counts(out).sum())

    results = []
    for d in ds:
        mesh, blocks, n = setup(d)
        calls[0] = 0
        hits = sweep(mesh, blocks, n, THRESHOLD)  # warm-up: builds the kernels
        sub_tiles, want_tiles = calls[0], schedule_sub_tiles(d, rows // sub_panel)
        if hits != expected or sub_tiles != want_tiles:
            print(f"D={d}: {hits} hits (expected {expected}), {sub_tiles} sub-tiles "
                  f"(the schedule's {want_tiles})", file=sys.stderr)
            return 1
        runs = []
        for k in range(3):
            # A new threshold each run, so that no result could be reused.
            sync()
            t = time.perf_counter()
            sweep(mesh, blocks, n, THRESHOLD + 1e-4 * (k + 1))
            runs.append(time.perf_counter() - t)
        dt = float(np.median(runs))
        pairs = n * (n - 1) // 2
        r = {"devices": d, "samples": n, "median_s": dt, "min_s": min(runs),
             "max_s": max(runs), "ring_steps": ring_num_steps(d), "sub_tiles": sub_tiles,
             "hits": hits}
        rate = ""
        if per_card:
            r["pairs_per_sec_per_gpu"] = pairs / dt / d
            rate = f", {r['pairs_per_sec_per_gpu'] / 1e6:.1f}M pairs/s per GPU"
        elif on_card:
            r["pairs_per_sec"] = pairs / dt
            rate = f", {r['pairs_per_sec'] / 1e6:.1f}M pairs/s on the one card"
        results.append(r)
        print(f"D={d}: {n} samples, median {dt:.4f} s (min {min(runs):.4f}, max "
              f"{max(runs):.4f}){rate}; {r['ring_steps']} ring steps, {sub_tiles} "
              f"sub-tiles, {hits} hits", file=sys.stderr)
        del blocks

    eff_key = None
    if per_card:
        # The target is defined against one card; say so when D = 1 was not swept.
        base = next((r for r in results if r["devices"] == 1), results[0])
        eff_key = f"efficiency_vs_{base['devices']}dev"
        if base["devices"] != 1:
            print(f"WARNING: D=1 not in the sweep; efficiency is relative to "
                  f"D={base['devices']}", file=sys.stderr)
        for r in results:
            r[eff_key] = r["pairs_per_sec_per_gpu"] / base["pairs_per_sec_per_gpu"]

    overlap = None
    if per_card and max(ds) >= 2:
        from torch.profiler import ProfilerActivity, profile

        mesh, blocks, n = setup(max(ds))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sweep(mesh, blocks, n, THRESHOLD + 0.01)
        overlap = covered_share(profiled_intervals(prof))
        print(f"transfer under count-kernel time at D={max(ds)}: {overlap}", file=sys.stderr)

    print(json.dumps({"weak_scaling": results, "overlap": overlap,
                      "target_efficiency": args.min_efficiency, "device": device}))
    if per_card and not args.no_assert:
        low = [r for r in results if r["devices"] >= 2 and r[eff_key] < args.min_efficiency]
        if low:
            print(f"FAIL: efficiency below {args.min_efficiency}: {low}", file=sys.stderr)
            return 1
    if not per_card:
        why = "the positions share one card" if on_card else "CPU times say nothing of a card"
        print(f"schedule validated: {expected} hits and the scheduled sub-tiles at every "
              f"D in {ds}; no efficiency, since {why}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    raise SystemExit(main())
