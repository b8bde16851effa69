#!/usr/bin/env python3
"""Where the card's time goes in the port's sweeps: ``torch.profiler`` traces
of the engine (hit-free and hitful) and of the one-position ring, each
sorted into categories by ``cuking_tpu_torch.utils.trace``.

The twin of ``tools/trace_report.py``, which traces the JAX package on a
TPU.  It keeps that tool's runs, sizes, thresholds and order:

1. ``engine_hitfree``: ``KingEngine`` over 16,384 samples x 100,000 sites
   of random packed words (``default_rng(seed)`` over the whole storage),
   panel 1024, the CUDA kernel (136 steps); a warm-up at 0.9, then the run
   at 0.91.
2. ``engine_hitful``: the same planes with 512 families of 8 clones planted
   (14,336 pairs of kin 0.5), a warm-up at 0.0884, then the run at
   0.08841.  Its rows must be exactly the planted pairs, kin == float32(0.5).
3. ``ring_1dev``: ``all_pairs_presharded`` over one ring position on the
   same card, the engine's device planes as its block, ``capacity_per_device``
   2^20 and sub-panel 1024; a warm-up at 0.0884, then the run at 0.08841.
   Its rows must equal the hitful sweep's, kin as uint32 bits.  One
   position makes no ring hop: the trace holds no peer copy, and the share
   of transfer time under count-kernel time is reported as none.

Each run is timed by the host clock once untraced and once under
``torch.profiler`` (CPU and CUDA activity), both ending in
``torch.cuda.synchronize()``: the difference is what tracing costs.  The
traced run's Chrome trace goes to ``OUTDIR/<run>/trace.json``, and that
file is read by ``utils.trace.analyze``, the reader that a CLI
``--profile_dir`` trace is read with.  The launch counters of both kernels
are read over each traced run.

``--device cpu`` runs the JAX tool's CPU sizes (192 x 2,000, panel 64, the
plain int8 matmul path, 8 families of 4); its traces hold no device event
and its times are no card's.  Without a card, and without ``--device
cpu``, it exits 2 with the reason and prints no number.

    python3 tools/torch_trace_report.py [--outdir DIR] [--device cuda|cpu] [--seed 0]

Prints each run's host wall times and hits on stderr, the three tables
(each headed by the card's name and power limit) on stdout, and one JSON
line last: each run's ``analyze`` dict, threshold, times, hits and counted
launches; the planted pairs; the launches of the whole process; the card.
Exit 0, or 1 when a check fails.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

import numpy as np


@dataclasses.dataclass(frozen=True)
class Sizes:
    samples: int
    sites: int
    panel: int
    kernel: str
    site_chunk_words: int
    families: int
    members: int


# tools/trace_report.py's sizes on the chip and on the CPU.
CARD = Sizes(16_384, 100_000, 1024, "cuda", 128, 512, 8)
CPU = Sizes(192, 2_000, 64, "matmul", 16, 8, 4)
RUNS = ("engine_hitfree", "engine_hitful", "ring_1dev")
TAGS = {"engine_hitfree": "engine sweep, hit-free (0.91 threshold)",
        "engine_hitful": "engine sweep, hitful (default threshold)",
        "ring_1dev": "ring sweep, 1 position, hitful"}


def make_engine(sizes: Sizes, seed: int, device: str):
    """The engine over random packed words, drawn from ``default_rng(seed)``
    over the whole storage (tools/trace_report.py:196-198)."""
    from cuking_tpu_torch.models.king import KingConfig, KingEngine, PanelStorage
    from cuking_tpu_torch.ops.bitset import PlaneLayout
    from cuking_tpu_torch.parallel.submatrix import Submatrix
    from cuking_tpu_torch.utils.stopwatch import StageLogger

    storage = PanelStorage(PlaneLayout.create(sizes.sites),
                           Submatrix.create(sizes.samples, 1, 0), sizes.panel)
    rng = np.random.default_rng(seed)
    storage.planes[:] = rng.integers(0, 2**32, storage.planes.shape, dtype=np.uint32)
    config = KingConfig(kin_threshold=0.9, panel=sizes.panel, kernel=sizes.kernel,
                        site_chunk_words=sizes.site_chunk_words, device=device)
    return KingEngine(storage, config, logger=StageLogger(enabled=False))


def plant_families(engine, sizes: Sizes) -> set:
    """Clones row ``f * members`` into the next ``members - 1`` rows for each
    family f (tools/trace_report.py:213-218), marks the planes for a new
    upload, and returns the planted pairs (i < j)."""
    planes, pairs = engine.storage.planes, set()
    for fam in range(sizes.families):
        src = fam * sizes.members
        rows = range(src, src + sizes.members)
        planes[:, src + 1:src + sizes.members] = planes[:, src:src + 1]
        pairs |= {(i, j) for i in rows for j in rows if i < j}
    engine.storage.mark_mutated()
    return pairs


def engine_rows(engine, threshold: float):
    engine.config = dataclasses.replace(engine.config, kin_threshold=threshold)
    return engine.run()


def ring_rows(engine, threshold: float):
    """The ring over one position on the engine's device, with the engine's
    device planes as its block (bench_torch.py's ``ring_path``)."""
    from cuking_tpu_torch.models.king import resolve_indexed_kernel, resolve_kernel
    from cuking_tpu_torch.parallel.ring import (
        RingMesh,
        all_pairs_presharded,
        ring_output_to_resultset,
    )

    config = engine.config
    out = all_pairs_presharded(
        [engine.planes_dev], engine.storage.submatrix.num_rows, RingMesh([engine.device]),
        resolve_kernel(config), kin_threshold=threshold, capacity_per_device=1 << 20,
        sub_panel=config.panel, indexed_kernel=resolve_indexed_kernel(config))
    return ring_output_to_resultset(out)


def planted_failures(rs, planted: set) -> list:
    """What keeps ``rs`` from being exactly the planted pairs at kin 0.5."""
    got = set(zip(rs.i_idx.tolist(), rs.j_idx.tolist()))
    out = []
    if got != planted:
        out.append(f"{len(got)} pairs, {len(got & planted)} of the {len(planted)} planted")
    if not np.all(rs.kin.view(np.uint32) == np.float32(0.5).view(np.uint32)):
        out.append("a kin other than float32(0.5)")
    return out


def same_rows(a, b) -> bool:
    return len(a) == len(b) and all(
        np.array_equal(getattr(a, f).view(np.uint32), getattr(b, f).view(np.uint32))
        for f in ("i_idx", "j_idx", "kin", "ibs0", "ibs1", "ibs2"))


def launch_counts() -> dict:
    from cuking_tpu_torch.ops import king_cuda, king_emit

    return {"king_counts": king_cuda.launches, "king_emit": king_emit.emit_launches}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--outdir", default=os.path.join(tempfile.gettempdir(),
                                                     "cuking_torch_traces"))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    from cuking_tpu_torch.utils import trace
    from cuking_tpu_torch.utils.card import card_name

    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        print("torch_trace_report: no CUDA device (torch.cuda.is_available() is false); "
              "pass --device cpu for a CPU check at small sizes", file=sys.stderr)
        return 2
    sizes = CARD if on_card else CPU
    if on_card:
        torch.cuda.set_device(0)
        card = card_name()
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": torch.cuda.device_count()}
    else:
        card = "no card (cpu): no device number"
        device = {"platform": "cpu", "kind": "cpu", "count": 0}

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize()

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    log(f"{card}; torch {torch.__version__}; {sizes}")
    start = launch_counts()
    engine = make_engine(sizes, args.seed, args.device)
    runs, failures = {}, []

    def capture(name: str, fn, threshold: float, warmup: float):
        fn(warmup)
        sync()
        t = time.perf_counter()
        fn(threshold)
        sync()
        untraced = time.perf_counter() - t
        path = os.path.join(args.outdir, name, "trace.json")
        before = launch_counts()
        with trace.traced(path, cuda=on_card) as stats:
            t = time.perf_counter()
            rs = fn(threshold)
            sync()
            wall = time.perf_counter() - t
        after = launch_counts()
        runs[name] = {"threshold": threshold, "wall_ms": 1e3 * wall,
                      "untraced_wall_ms": 1e3 * untraced, "hits": len(rs),
                      "launches_counted": {k: after[k] - before[k] for k in after},
                      "trace": path, "analysis": stats}
        log(f"{name}: traced {1e3 * wall:.1f} ms, untraced {1e3 * untraced:.1f} ms "
            f"(host clock), {len(rs)} hits")
        return rs

    capture("engine_hitfree", lambda t: engine_rows(engine, t), 0.91, 0.9)
    planted = plant_families(engine, sizes)
    hitful = capture("engine_hitful", lambda t: engine_rows(engine, t), 0.08841, 0.0884)
    failures += [f"hitful: {f}" for f in planted_failures(hitful, planted)]
    ring = capture("ring_1dev", lambda t: ring_rows(engine, t), 0.08841, 0.0884)
    if not same_rows(ring, hitful):
        failures.append(f"ring: {len(ring)} rows differ from the hitful sweep's {len(hitful)}")
    end = launch_counts()

    for name in RUNS:
        print(trace.report(TAGS[name], runs[name]["analysis"], card), flush=True)
    for f in failures:
        log(f"FAIL: {f}")
    print(json.dumps({"runs": runs, "planted_pairs": len(planted),
                      "launches_total": {k: end[k] - start[k] for k in end},
                      "checks_failed": failures, "card": card, "device": device,
                      "seed": args.seed, "sizes": dataclasses.asdict(sizes)}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    raise SystemExit(main())
