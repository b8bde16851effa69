#!/usr/bin/env python3
"""Cell A's engine sweep, the early stop of an overflowing sweep, and the
ring's peak memory across a forced retry, for one or more checkouts of the
port, each in a fresh process, in the order given.

    python3 tools/torch_sweep_ab.py --roots PARENT,.,.,PARENT

Each root is a directory holding a ``cuking_tpu_torch`` package; the
process measuring it runs from that directory with it first on the path,
and builds its kernels there.  Naming two checkouts in turns (parent,
change, change, parent) compares them within one call on one card.  Per
root it measures, on ``cuda:0``:

* **Cell A**: the engine at 32,768 samples x 100,000 sites with 64 planted
  duplicate pairs (threshold 0.0884, 528 panel-pair steps): ``--repeats``
  sweeps by the host clock ending in ``torch.cuda.synchronize()``, and one
  profiled sweep's device busy share (busy time over wall time).
* **Ring A**: cell A through a ring of 4 positions, all on ``cuda:0``
  (``chip_smoke.py`` phase 6): ``--repeats`` sweeps by the host clock, each
  returning the 64 planted pairs.
* **Early stop**: the same planes at threshold -2.0 (keep all) with the
  default ``max_results`` (2^20 result slots): every step's 1,048,576 hits
  pass ``max_results`` within the first 64 steps.  It reports the steps
  queued when ResourceExhausted was raised (emit launches), the seconds
  from the sweep's start to the error, and to the device's end.
* **Ring retry**: 4,096 x 100,000 keep-all through a ring of 2 positions on
  ``cuda:0`` from ``capacity_per_device`` 2^21 (each position's 4.2M hits
  overflow it, so the ring re-runs at 2^22): the peak device memory of the
  call (``max_memory_allocated``) beside the planes, the first run's hit
  buffers and the retry's.

Prints the card's name and power limit, one line per root, and one JSON
line last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

SITES = 100_000
SEED = 20261016


def cell_a_storage():
    """Cell A's panel storage: uniform random planes with 64 planted exact
    duplicates (32 inside a panel, 32 across panels; every sample in one
    pair only).  Returns the storage and the planted pairs (i < j)."""
    from cuking_tpu_torch.models.king import PanelStorage
    from cuking_tpu_torch.ops.bitset import PlaneLayout
    from cuking_tpu_torch.parallel.submatrix import Submatrix
    from cuking_tpu_torch.utils.synthetic import fill_random_planes

    rng = np.random.default_rng(SEED + 1)
    layout = PlaneLayout.create(SITES)
    storage = PanelStorage(layout, Submatrix.create(32_768, 1, 0), 1024)
    fill_random_planes(storage.planes, layout, rng)
    planted = [(k * 1024 + 10 + k, k * 1024 + 500 + k) for k in range(32)]
    planted += [((k - 32) * 1024 + 700 + k, ((k - 25) % 32) * 1024 + 900 + k)
                for k in range(32, 64)]
    for a, b in planted:
        storage.planes[:, b] = storage.planes[:, a]
    storage.mark_mutated()
    return storage, [(min(a, b), max(a, b)) for a, b in planted]


def busy_share(fn) -> tuple[float, float]:
    """(wall s, device busy share) of ``fn`` under torch.profiler: the
    device's busy time (the union of its intervals) over the wall time."""
    import torch

    from cuking_tpu_torch.utils import trace

    torch.cuda.synchronize()
    with trace.traced() as stats:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    return wall, stats["busy_union_ms"] / 1e3 / wall


def measure(repeats: int) -> dict:
    import torch

    from cuking_tpu_torch.models.king import KingConfig, KingEngine
    from cuking_tpu_torch.ops import king_emit
    from cuking_tpu_torch.ops.bitset import PlaneLayout
    from cuking_tpu_torch.ops.king_cuda import panel_counts_cuda, panel_counts_cuda_indexed
    from cuking_tpu_torch.parallel.ring import (
        RingMesh,
        _pad_and_shard,
        all_pairs_presharded,
        all_pairs_sharded,
        ring_output_to_resultset,
    )
    from cuking_tpu_torch.utils.status import ResourceExhaustedError
    from cuking_tpu_torch.utils.stopwatch import StageLogger
    from cuking_tpu_torch.utils.synthetic import random_planes

    quiet = StageLogger(enabled=False)
    storage, planted = cell_a_storage()
    engine = KingEngine(storage, KingConfig(kernel="cuda", device="cuda"), logger=quiet)
    engine.run()  # builds the kernels, uploads the planes
    sweeps = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t = time.perf_counter()
        rs = engine.run()
        torch.cuda.synchronize()
        sweeps.append(time.perf_counter() - t)
    got = sorted(zip(rs.i_idx.tolist(), rs.j_idx.tolist()))
    if got != sorted(planted):
        raise RuntimeError(f"cell A returned {len(got)} pairs, not the 64 planted")
    profiled_s, busy = busy_share(engine.run)

    n = storage.submatrix.num_rows
    mesh = RingMesh(["cuda:0"] * 4)
    blocks, _ = _pad_and_shard(storage.planes, n, mesh, 1)
    ring_sweeps = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = all_pairs_presharded(blocks, n, mesh, panel_counts_cuda, kin_threshold=0.0884,
                                   indexed_kernel=panel_counts_cuda_indexed)
        torch.cuda.synchronize()
        ring_sweeps.append(time.perf_counter() - t)
        rs = ring_output_to_resultset(out)
        if sorted(zip(rs.i_idx.tolist(), rs.j_idx.tolist())) != sorted(planted):
            raise RuntimeError(f"ring A returned {len(rs)} pairs, not the 64 planted")
    del blocks, out

    over = KingEngine(storage, KingConfig(kernel="cuda", device="cuda", kin_threshold=-2.0),
                      logger=quiet)
    over.planes_dev
    steps = len(over._panel_pair_params())
    torch.cuda.synchronize()
    before = king_emit.emit_launches
    t = time.perf_counter()
    try:
        over.run()
        raise RuntimeError("the keep-all sweep did not pass max_results")
    except ResourceExhaustedError:
        error_s = time.perf_counter() - t
        queued = king_emit.emit_launches - before
    torch.cuda.synchronize()
    drained_s = time.perf_counter() - t
    del engine, over

    rng = np.random.default_rng(SEED + 2)
    planes = random_planes(4096, PlaneLayout.create(SITES), rng)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    first = 1 << 21
    out = all_pairs_sharded(planes, 4096, RingMesh(["cuda:0"] * 2), panel_counts_cuda,
                            kin_threshold=-2.0, capacity_per_device=first,
                            indexed_kernel=panel_counts_cuda_indexed)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    if out.capacity_per_device <= first or int(out.counts.sum()) != 4096 * 4095 // 2:
        raise RuntimeError(f"the ring did not retry past {first} slots with every pair")
    return {
        "cell_a_sweep_s": sweeps, "cell_a_profiled_s": profiled_s, "cell_a_busy": busy,
        "ring_a_sweep_s": ring_sweeps,
        "early_stop": {"steps": steps, "queued": queued, "error_s": error_s,
                       "drained_s": drained_s},
        "ring_retry": {"peak_bytes": peak, "planes_bytes": planes.nbytes,
                       "first_hits_bytes": 2 * first * 24,
                       "retry_hits_bytes": 2 * out.capacity_per_device * 24},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--roots", default=".",
                    help="comma-separated checkouts, measured in this order")
    ap.add_argument("--repeats", type=int, default=3, help="timed cell A sweeps per root")
    ap.add_argument("--child", action="store_true",
                    help="measure the package on the path and print one JSON line")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_sweep_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.child:
        print(json.dumps(measure(args.repeats)))
        return 0
    from cuking_tpu_torch.utils.card import card_name

    card = card_name()
    print(card, flush=True)
    runs = []
    for root in args.roots.split(","):
        root = os.path.abspath(root)
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             "--repeats", str(args.repeats)],
            cwd=root, env=dict(os.environ, PYTHONPATH=root), capture_output=True,
            text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            raise RuntimeError(f"{root}: the measuring process exited {proc.returncode}")
        run = {"root": root, **json.loads(proc.stdout.strip().splitlines()[-1])}
        runs.append(run)
        stop, ring = run["early_stop"], run["ring_retry"]
        print(f"{root}: cell A sweeps " + ", ".join(f"{s:.4f}" for s in run["cell_a_sweep_s"])
              + f" s, profiled {run['cell_a_profiled_s']:.4f} s with the device "
              f"{100 * run['cell_a_busy']:.2f}% busy; ring A sweeps "
              + ", ".join(f"{s:.4f}" for s in run["ring_a_sweep_s"])
              + f" s; early stop after {stop['queued']} of "
              f"{stop['steps']} steps queued, error at {stop['error_s']:.4f} s, device done "
              f"at {stop['drained_s']:.4f} s; ring retry peak {ring['peak_bytes']:,} B "
              f"(planes {ring['planes_bytes']:,}, first hits {ring['first_hits_bytes']:,}, "
              f"retry hits {ring['retry_hits_bytes']:,}) ({card})", flush=True)
    print(json.dumps({"card": card, "runs": runs}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
