#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``cuking_tpu_torch``) once on one NVIDIA GPU.

Run from the repository root with one CUDA device::

    python3 chip_smoke.py

Phases (any failure exits nonzero):

0. Environment: torch/CUDA versions, ``nvcc --version``, the card's name and
   power limit.
0b. Before this process makes its CUDA context: the memory limit that the
   CLI's own ``check_engine_fit`` reads, in a fresh process at that call (on
   ``tests/golden/input.parquet``; the process exits there), as a Batch
   task's would, printed beside the limit that the cohort plan assumes
   (``tools/torch_capacity_plan.H100_FREE_MEMORY``).
1. Build the CUDA count kernels from ``cuking_tpu_torch/csrc`` (nvcc); print
   the build time and ``ptxas -v``'s registers and spills.
2. The wgmma count kernel and its yardstick, the AND + popcount kernel,
   against the five-block and the 9-block plain versions on the card, all
   six counters bit for bit, and against the numpy oracle on sampled pairs:
   the indexed entry (offsets into a 4,096-row storage, separate
   ``planes_j``), an asymmetric ``panel_j``, a ``tri`` diagonal pair,
   W = 100 with partial tiles, the sliced entry, rows that are all missing,
   all het, all hom-ref, all hom-alt or have the sign bit set (at 100,000
   sites and at W = 4), and 256 x 256 at 1,000,000 sites.  Then CUDA-event
   times at the engine's shape (1024 x 1024 pairs, off the diagonal and
   ``tri``) at 100,000 and at 1,000,000 sites: the kernel, the AND +
   popcount kernel (``prev_ms``), one ``torch._int_mm`` of the stacked
   9-block indicators (``library_ms``), the two ``torch._int_mm`` calls of
   the five products, the kernel's own operations (``library_five_ms``),
   the plain version, and the bound computed from the shapes.
2b. The emit kernel against its plain version on the card, on the same
   counters, fields and count: the count kernel's counters at 1024 x 1024
   (off the diagonal; a ``tri`` diagonal pair; limits inside the block),
   random counters with zero-het rows (NaN, -inf kin) and three pairs whose
   kin equals the threshold, ``strict`` and ``sym``, and an overflow past
   ``capacity`` whose count stays exact.  Then CUDA-event times at the
   engine's shape, hit-free and keep-all, beside the plain version and the
   bound (the counters read once, the hits written once).
3. The main path: ``KingEngine`` at 32,768 samples x 100,000 sites with 64
   planted duplicate pairs; exactly those must come out, with kin == 0.5.
   Kernel launch counts are read from this run.  One more sweep's step loop
   runs under ``torch.cuda.set_sync_debug_mode("error")``: a step that
   waits for the device fails it, and its deliberate waits for the count
   copy ``LIMIT_CHECK_WINDOW`` copies back (528 // 64 - 4 = 4) are counted.
3b. The early stop: the same planes at threshold -2.0, so the hits pass the
   default ``max_results`` within the first 64 steps; the sweep must raise
   ResourceExhausted with at most (4 + 1) x 64 of its 528 steps queued.
4. Keep-all parity at 4,096 x 100,000 (8,386,560 hits, past the default
   2^20 slots, so the sweep re-runs at 2^23): the cuda engine, the matmul
   engine and the cuda engine with the plain emit step give identical
   results.
5. The CLI end to end on a synthetic Parquet input (pyarrow is required):
   split 1, the three shards of split 2 merged, and the CPU plain path, all
   equal.
6. The ring at full width: ``all_pairs_sharded`` over 4 positions, all on
   ``cuda:0``, on phase 3's planes; it must return exactly the engine's
   ResultSet.  The positions share one card, so its time is a check, not a
   scaling figure.
7. Keep-all rings at 4,096 x 100,000 (phase 4's planes): a 3-position ring
   (odd D, no wrap step), the three shards of split 2 on a 2-position mesh
   (offset triangle and rectangular ring), and forced auto-retries from
   ``capacity_per_device`` 2^16 and 2^21; each must equal phase 4's cuda
   engine.  Each retry's peak device memory must stay inside
   ``check_ring_fit``'s model, and the retry from 2^21 must hold one set
   of hit buffers per position: the first run's are freed first.
8. The CLI on the mesh, on phase 5's input: ``--use_mesh --device
   cuda:0,cuda:0`` at split 1 and split 2 merged, and ``--distributed`` in a
   subprocess (a world of 1 with NCCL, 4 positions on cuda:0); both must
   equal phase 5's split-1 rows.
9. Dense ``king()`` at 2,048 x 100,000 on the card against the plain version
   on the card (kin as uint32 bits, NaN included), and the popcount engine
   at 1,024 x 10,000 against the cuda engine.
10. The Cloud Batch fan-out: a synthetic Parquet input of 2,048 samples x
    100,000 sites (5% missing, 4 partitions, planted related pairs), the
    Batch job rendered for ``--split-factor 2`` with a shared
    ``--profile_dir``, each of its 3 task commands run under ``/bin/sh -c``
    with ``BATCH_TASK_INDEX`` set, as Batch runs them in the container, then
    ``wait_for_completion`` on a stub that reports ``SUCCEEDED`` (it writes
    ``_SUCCESS``).  The merged partitions must equal a split-1 CLI run, and
    each task's trace must show ``king_counts_wgmma_kernel`` launches; each
    task's wall time, ingest rate and device busy share are printed.  The
    same job rendered without ``--profile_dir`` runs each task once more,
    just before its traced run, and must merge to the same rows: the
    difference in wall time is what tracing costs.  A bare process that
    imports the CLI and makes the CUDA context is timed once, as the part of
    a task's wall time that is start-up.  These are smoke-size tasks (one
    kernel launch each), not a deployment's shard.
11. BASELINE-scale parity: ``tools/torch_baseline_parity.run_parity`` at
    1,000 x 100,000 through the CLI on cuda: every finite-kin pair bit-exact
    against the numpy oracle, the 0.0884-thresholded run, and the merged
    ten shards of split 4; each stage's wall time is printed.
12a. The ring's copy between cards, forced onto one card
    (``ring._SideStreams.copy``), twice under a spin kernel on the compute
    stream: a first copy of a block of 16,384 rows x 100,000 sites makes
    the side streams and the receive block (its time is printed), and the
    second, into the reused block, must be delivered before the spin ends:
    the copy does not queue behind compute, which is all one card can
    show.
12b. ``tools/torch_scaling_bench.py --same-card --devices 1 2 3 4`` at
    8,192 rows per position: the same planted hits at every D, and the
    ring's steps and sub-tiles as ``ring_schedule`` has them.
12c. Only with more than one card visible: the scaling tool with one
    position per card (efficiency against D = 1 and the share of transfer
    time under count-kernel time), and phase 6's cell A through a ring of
    one position per card: the engine's rows, the sweep time, each card's
    peak memory against ``check_ring_fit``'s model, and the overlap share.
    On one card it prints that it did not run, and why.
13a. The main path at a deployment's shard size: a 69,632 x 1,000,000
    shard (31,252 words; 4,352,278,528 plane words, 17.41 GB) at split 1 and
    threshold 0.0884, from host planes through the engine's own upload, with
    clone families of 4 at rows 0-3, across the first het row past word
    2^31 and the first hom row past word 2^32, in the last panel, and row 0
    cloned into the last row (``tools/torch_shard_at_scale.py``).  Exactly
    the planted pairs must come out (kin == 0.5 bit for bit, ibs0 == ibs1
    == 0, ibs2 the row's defined sites, each equal to the numpy oracle),
    with 2,346 launches of each kernel and the peak device memory inside
    ``check_engine_fit``'s model; the last diagonal and the (first, last)
    panel pairs on the engine's device planes must equal the five-block
    plain version.  The sweep time, pairs/s and ms per step are printed
    beside phase 2's isolated 1M-site pair.
13b. The shard at the fit limit: the most rows at 1,000,000 sites that
    ``check_engine_fit`` admits at the default ``KingConfig`` with the free
    memory read just before (or, if the host's available memory holds
    fewer, the host's, said so), uploaded through ``planes_dev`` (timed,
    with the host RSS before and after), then keep-all into a
    ``max_results`` buffer: ResourceExhausted within (4 + 1) x 64 steps, no
    out-of-memory error, the peak inside the model (the headroom left is
    printed).  On the same device planes the last diagonal and the
    (first, last) pairs equal the AND + popcount yardstick on all six
    counters and the numpy oracle on sampled pairs, tile corners included.
    The peak host RSS is printed against ``cloud/batch_submit.py``'s planes
    term.  Phase 13's time is printed.
14. One whole CLI task from Parquet at 1,000,000 sites
    (``tools/torch_cli_at_scale.run_cell``): 16,384 samples, 16 site-ordered
    ZSTD files of ~9.4M cells each (577 sites over every sample, cell O's
    file size), with planted clone and half-copy families; the CLI runs in
    a child process on the card.  Its rows must be exactly the planted pairs
    (clones kin == float32(0.5), ibs0 == ibs1 == 0; half-copies equal to the
    numpy oracle), the planes of the sampled rows equal the same genotypes
    packed by ``pack_genotypes``, the planes' hom-ref / het / hom-alt bits
    the writer's tallies, and the child's launches one of each kernel per
    step (136).  The stage times and peak RSS are printed.

Every count of kernel launches (``king_cuda.launches`` for the count
kernel, ``king_emit.emit_launches`` for the emit kernel) is set to 0 just
before a path runs and read just after (phase 10's tasks run in processes
of their own, so their launches are the kernel events of their traces); the
AND + popcount yardstick may launch on no path.  Phase 3
also profiles one more sweep for the device's busy share.  The
second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Stage logs go to stderr.
"""

from __future__ import annotations

import json
import os
import re
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

SITES = 100_000
SEED = 20261016
REPO = os.path.dirname(os.path.abspath(__file__))


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def say(msg: str) -> None:
    print(msg, flush=True)


# The kernels of the main path, by the name of their launch counters.
KERNELS = ("king_counts", "king_emit")


def reset_launches() -> None:
    from cuking_tpu_torch.ops import king_cuda, king_emit

    king_cuda.launches = 0
    king_emit.emit_launches = 0


def read_launches(what: str, path_kernels=KERNELS) -> dict:
    """Launches of each kernel since :func:`reset_launches`; fails when a
    kernel of the path (``path_kernels``) did not launch."""
    from cuking_tpu_torch.ops import king_cuda, king_emit

    counts = {"king_counts": king_cuda.launches, "king_emit": king_emit.emit_launches}
    for name in path_kernels:
        check(counts[name] > 0, f"{what} launched no {name} kernel")
    return counts


def add_launches(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in KERNELS}


def defined_sites(planes: np.ndarray, row: int) -> int:
    """Defined (not (1,1)) sites of one stored sample."""
    d = ~(planes[0, row] & planes[1, row])
    return int(np.unpackbits(d.view(np.uint8)).sum())


def cuda_ms(fn, iters: int, warmup: int) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def queued_ms(fn, iters: int, warmup: int) -> tuple[float, float]:
    """(device ms per launch, host ms per launch) of launches that the host
    queues behind a spin kernel of ~10 ms, so that the device runs them back
    to back and the CUDA events time the kernels, not the host's launch
    rate; valid while the host's time for all launches stays under the
    spin."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    host_ms = 1e3 * (time.perf_counter() - t) / iters
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters, host_ms


def phase_env() -> str:
    import torch

    from importlib import metadata

    def version(dist: str) -> str:
        try:
            return metadata.version(dist)
        except metadata.PackageNotFoundError:
            return "absent"

    say(f"phase 0: python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, " + ", ".join(
            f"{d} {version(d)}" for d in ("numpy", "pyarrow", "gcsfs", "fsspec"))
        + f", {torch.cuda.device_count()} device(s)")
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = f"{CUDA_HOME}/bin/nvcc" if CUDA_HOME else "nvcc"
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    say(f"nvcc: {out[-1] if out else '?'}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    say(smi)
    return smi.splitlines()[0]


# Runs the CLI with its arguments up to its check_engine_fit call, prints the
# free memory and the limit that the check reads there as one JSON line, and
# exits.
_CLI_LIMIT_PROBE = """
import json, os, sys, torch
from cuking_tpu_torch import cli
from cuking_tpu_torch.utils import hbm
def limit(device, read=hbm.device_bytes_limit):
    print(json.dumps([torch.cuda.mem_get_info(device)[0], read(device)]), flush=True)
    os._exit(0)
hbm.device_bytes_limit = limit
sys.exit(cli.main(sys.argv[1:]))
"""


def phase_task_limit(card: str) -> None:
    from cuking_tpu_torch.utils.hbm import _USABLE_FRACTION
    from tools.torch_capacity_plan import H100_FREE_MEMORY

    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(
            [sys.executable, "-c", _CLI_LIMIT_PROBE, "--input_uri",
             f"{REPO}/tests/golden/input.parquet", "--output_uri", f"{tmp}/out.parquet",
             "--kin_threshold", "0.0884"],
            cwd=REPO, capture_output=True, text=True, timeout=300)
    check(proc.returncode == 0 and proc.stdout.strip(),
          f"the CLI did not reach check_engine_fit (exit {proc.returncode}):\n{proc.stderr}")
    free_b, limit = json.loads(proc.stdout.strip().splitlines()[-1])
    planned = int(H100_FREE_MEMORY * _USABLE_FRACTION)
    say(f"phase 0b: the CLI's check_engine_fit read {free_b:,} B free and a limit of "
        f"{limit:,} B in a fresh process; the cohort plan assumes {H100_FREE_MEMORY:,} B "
        f"free, a limit of {planned:,} B ({limit - planned:+,} B) ({card})")


def phase_build() -> None:
    from cuking_tpu_torch.ops import king_cuda

    t = time.perf_counter()
    log = king_cuda.build()
    say(f"phase 1: built {king_cuda.LIB_PATH} in {time.perf_counter() - t:.1f} s")
    kernel = "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = next((k for k in ("counts_wgmma", "counts_popc", "emit")
                           if f"king_{k}_kernel" in line), "?")
        elif "Used" in line or "spill" in line:
            say(f"  ptxas, {kernel} kernel: {line.split(':', 1)[-1].strip()}")


# Card peaks for the bound (NVIDIA's H100 SXM data sheet, dense, 700 W).
PEAK_INT8_OPS = 1.979e15
PEAK_BYTES = 3.35e12


def count_bound(ni: int, nj: int, words: int) -> tuple[float, str]:
    """The least time (ms) one count launch could take, and what bounds it:
    five int8 products of 2 operations per pair and padded site, against
    the planes read once and the six int32 counters written once."""
    ops = 10 * ni * nj * 32 * words
    nbytes = 2 * (ni + nj) * words * 4 + 6 * ni * nj * 4
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def check_oracle_pairs(counts, planes_i, i_off: int, planes_j, j_off: int, layout,
                       pairs, name: str) -> None:
    """Holds the counters ``counts`` (six [NI, NJ]) of rows ``i_off + x`` of
    host planes ``planes_i`` against rows ``j_off + y`` of ``planes_j`` to
    the numpy oracle at each pair (x, y) of ``pairs``."""
    from cuking_tpu_torch.ops.bitset import planes_to_genotypes
    from cuking_tpu_torch.ops.oracle import oracle_counts

    got = [c.cpu().numpy() for c in counts]
    gi = planes_to_genotypes(planes_i[:, [i_off + int(x) for x, _ in pairs]], layout)
    gj = planes_to_genotypes(planes_j[:, [j_off + int(y) for _, y in pairs]], layout)
    for n, (x, y) in enumerate(pairs):
        exp = oracle_counts(gi[n:n + 1], gj[n:n + 1])
        for k, e in enumerate(exp):
            check(int(got[k][x, y]) == int(e[0, 0]),
                  f"{name}: oracle pair ({x}, {y}): counter {exp._fields[k]}")


def phase_kernel(card: str) -> dict:
    import torch

    from cuking_tpu_torch.ops.bitset import PlaneLayout
    from cuking_tpu_torch.ops.king_cuda import (
        five_block_indicators,
        panel_counts_cuda,
        panel_counts_cuda_indexed,
        panel_counts_five_block,
        panel_counts_popc_indexed,
    )
    from cuking_tpu_torch.ops.king_mm import indicator_planes, panel_counts_matmul
    from cuking_tpu_torch.utils.synthetic import edge_planes, random_planes

    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda", 0)

    def on_card(planes_np):
        return torch.from_numpy(planes_np.view(np.int32)).to(dev)

    layout = PlaneLayout.create(SITES)
    store_np = random_planes(4096, layout, rng)
    pj_np = random_planes(2048, layout, rng)
    small_layout = PlaneLayout.create(3_100)  # W = 100: a ragged popc chunk
    small_np = random_planes(1800, small_layout, rng)
    edge_np = edge_planes(320, layout, rng)
    w4_layout = PlaneLayout.create(128)  # W = 4: one staged slice per row
    w4_np = edge_planes(300, w4_layout, rng)
    long_layout = PlaneLayout.create(1_000_000)  # W = 31,252
    long_np = random_planes(512, long_layout, rng)
    stores = {name: (on_card(p), p, lay) for name, p, lay in (
        ("store", store_np, layout), ("pj", pj_np, layout),
        ("small", small_np, small_layout), ("edge", edge_np, layout),
        ("w4", w4_np, w4_layout), ("long", long_np, long_layout))}

    # name, i storage, i_off, ni, j storage, j_off, nj, tri, sliced entry,
    # rows of the case that the oracle sample must include
    cases = [
        ("indexed 1024x1024, i_off=1000 into 4096 rows, separate planes_j j_off=300",
         "store", 1000, 1024, "pj", 300, 1024, 0, False, ()),
        ("indexed asymmetric panel_j=640, i_off=2048, j_off=1537",
         "store", 2048, 1024, "store", 1537, 640, 0, False, ()),
        ("indexed tri=1 diagonal pair at 1024 (i<j compared)",
         "store", 1024, 1024, "store", 1024, 1024, 1, False, ()),
        ("indexed ragged W=100 (3,100 sites), 1000x700 partial tiles",
         "small", 17, 1000, "small", 1100, 700, 0, False, ()),
        ("sliced entry 1024x1024", "store", 0, 1024, "pj", 1024, 1024, 0, True, ()),
        ("edge rows (all missing, het, hom-ref, hom-alt; sign-bit words), 320x320 at "
         "100,000 sites", "edge", 0, 320, "edge", 0, 320, 0, False, range(6)),
        ("W=4 (128 sites) with the edge rows, 300x300",
         "w4", 0, 300, "w4", 0, 300, 0, False, range(6)),
        ("256x256 at 1,000,000 sites (W=31,252)",
         "long", 0, 256, "long", 256, 256, 0, False, ()),
    ]
    max_err = 0
    for name, si, i_off, ni, sj, j_off, nj, tri, sliced, edge_rows in cases:
        (pi, pi_np, lay), (pjc, pj_np_c, _) = stores[si], stores[sj]
        a, b = pi[:, i_off:i_off + ni], pjc[:, j_off:j_off + nj]
        if sliced:
            got = panel_counts_cuda(a.contiguous(), b.contiguous())
        else:
            got = panel_counts_cuda_indexed(pi, i_off, j_off, tri, ni, planes_j=pjc, panel_j=nj)
        popc = panel_counts_popc_indexed(pi, i_off, j_off, tri, ni, planes_j=pjc, panel_j=nj)
        refs = {"the five-block plain version": panel_counts_five_block(a, b),
                "the 9-block plain version": panel_counts_matmul(a, b)}
        torch.cuda.synchronize()
        keep = torch.ones((ni, nj), dtype=torch.bool, device=dev).triu(1) if tri else None
        for what, ref in refs.items():
            for who, counts in (("kernel", got), ("AND+popc kernel", popc)):
                for k, (g, e) in enumerate(zip(counts, ref)):
                    if keep is not None:
                        g, e = g[keep], e[keep]
                    err = int((g.long() - e.long()).abs().max())
                    if who == "kernel":
                        max_err = max(max_err, err)
                    check(err == 0, f"{name}: {who} counter {got._fields[k]} differs "
                                    f"from {what} by {err}")
        # The numpy oracle on sampled pairs: 24 at random, and every named row
        # against every named row and against 8 random rows.
        pairs = list(zip(rng.integers(0, ni, 24).tolist(), rng.integers(0, nj, 24).tolist()))
        for r in edge_rows:
            pairs += [(r, c) for c in edge_rows]
            pairs += [(r, int(c)) for c in rng.integers(0, nj, 4)]
            pairs += [(int(c), r) for c in rng.integers(0, ni, 4)]
        if tri:
            pairs = [(min(x, y), max(x, y)) for x, y in pairs if x != y]
        check_oracle_pairs(got, pi_np, i_off, pj_np_c, j_off, lay, pairs, name)
        say(f"phase 2: {name}: six counters equal the five-block and 9-block plain "
            f"versions (kernel and AND+popc kernel) and {len(pairs)} oracle pairs")

    def timings(planes, words: int, iters: int) -> dict:
        """CUDA-event times at the engine's shape: an off-diagonal 1024 x 1024
        panel pair, and the diagonal pair with tri."""
        off = lambda: panel_counts_cuda_indexed(planes, 0, 1024, 0, 1024)
        t = {"ms": cuda_ms(off, iters, 3)}
        t["prev_ms"] = cuda_ms(lambda: panel_counts_popc_indexed(planes, 0, 1024, 0, 1024),
                               max(2, iters // 4), 1)
        x = indicator_planes(planes[:, :1024]).reshape(3 * 1024, -1)
        y = indicator_planes(planes[:, 1024:2048]).reshape(3 * 1024, -1)
        t["library_ms"] = cuda_ms(lambda: torch._int_mm(x, y.t()), max(2, iters // 4), 1)
        del x, y
        h_i, v_i, u_i = five_block_indicators(planes[:, :1024])
        h_j, v_j, u_j = five_block_indicators(planes[:, 1024:2048])
        hv_i, hv_j = torch.cat([h_i, v_i]), torch.cat([h_j, v_j])
        del h_i, v_i, h_j, v_j
        t["library_five_ms"] = cuda_ms(
            lambda: (torch._int_mm(hv_i, hv_j.t()), torch._int_mm(u_i, u_j.t())),
            max(2, iters // 4), 1)
        del hv_i, hv_j, u_i, u_j
        t["plain_ms"] = cuda_ms(lambda: panel_counts_five_block(planes[:, :1024],
                                                                planes[:, 1024:2048]), 2, 1)
        t["ms_repeat"] = cuda_ms(off, iters, 1)
        t["tri_ms"] = cuda_ms(lambda: panel_counts_cuda_indexed(planes, 0, 0, 1, 1024), iters, 1)
        t["bound_ms"], t["bound_by"] = count_bound(1024, 1024, words)
        torch.cuda.empty_cache()
        return t

    store = stores["store"][0]
    del stores
    torch.cuda.empty_cache()
    t100k = timings(store, layout.words, 20)
    say(f"phase 2: 1024x1024 pairs x {layout.words} words: kernel {t100k['ms']:.3f} ms "
        f"(again {t100k['ms_repeat']:.3f}, tri {t100k['tri_ms']:.3f}), AND+popc "
        f"{t100k['prev_ms']:.3f} ms, torch._int_mm of the "
        f"9-block indicators {t100k['library_ms']:.3f} ms, of the five products "
        f"{t100k['library_five_ms']:.3f} ms, plain version "
        f"{t100k['plain_ms']:.3f} ms, bound {t100k['bound_ms']:.3f} ms ({card})")
    del store
    long_rows = on_card(random_planes(2048, long_layout, rng))
    t1m = timings(long_rows, long_layout.words, 6)
    del long_rows
    torch.cuda.empty_cache()
    say(f"phase 2: 1024x1024 pairs x {long_layout.words} words: kernel {t1m['ms']:.3f} ms "
        f"(again {t1m['ms_repeat']:.3f}, tri {t1m['tri_ms']:.3f}), AND+popc "
        f"{t1m['prev_ms']:.3f} ms, torch._int_mm 9-block "
        f"{t1m['library_ms']:.3f} ms, five products {t1m['library_five_ms']:.3f} ms, plain version {t1m['plain_ms']:.3f} ms, bound "
        f"{t1m['bound_ms']:.3f} ms ({card})")
    return {"max_abs_err": max_err, **t100k, "at_1m_sites": t1m}


PEAK_FP32_OPS = 67e12  # non-tensor float32 (NVIDIA's H100 SXM data sheet)


def emit_bound(pairs: int, hits: int) -> tuple[float, str]:
    """The least time (ms) one emit launch could take over ``pairs``
    candidate pairs, and what bounds it: the bytes the function needs (the
    four kin counters of every candidate, 16 B; for each hit the other two
    counters, 8 B, and its row written, 24 B), against ~10 operations per
    pair (the kin expression and the mask) at the card's non-tensor float32
    rate."""
    t_bytes = (16 * pairs + 32 * hits) / PEAK_BYTES
    t_ops = 10 * pairs / PEAK_FP32_OPS
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops > t_bytes else "bytes"


def _sorted_rows(rows: np.ndarray) -> np.ndarray:
    return rows[:, np.lexsort(rows[::-1])]


def compare_emits(kernel_hits, plain_hits, what: str) -> int:
    """Holds the kernel's HitBuffer against the plain version's (which had
    room for every hit): the same exact count, and the same rows; past the
    kernel's capacity, each row it kept is one of the plain version's.
    Returns the largest difference of a count or field (0 when they agree)."""
    total, ref_total = int(kernel_hits.count), int(plain_hits.count)
    check(total == ref_total, f"{what}: the kernel counted {total} hits, the plain "
                              f"version {ref_total}")
    got, ref = kernel_hits.rows(total), _sorted_rows(plain_hits.rows(ref_total))
    if total <= kernel_hits.capacity:
        got = _sorted_rows(got)
    else:
        check(got.shape[1] == kernel_hits.capacity, f"{what}: kept {got.shape[1]} rows")
        keys = ref[0].astype(np.int64) << 32 | ref[1].astype(np.int64)
        at = np.searchsorted(keys, got[0].astype(np.int64) << 32 | got[1].astype(np.int64))
        check(bool((at < len(keys)).all()), f"{what}: a kept row is no hit")
        ref = ref[:, at]
    err = int(np.abs(got.astype(np.int64) - ref.astype(np.int64)).max(initial=0))
    check(err == 0, f"{what}: a field differs from the plain version by {err}")
    return err


def phase_emit(card: str) -> dict:
    import itertools

    import torch

    from cuking_tpu_torch.ops.bitset import PlaneLayout
    from cuking_tpu_torch.ops.compaction import HitBuffer
    from cuking_tpu_torch.ops.king_cuda import panel_counts_cuda_indexed
    from cuking_tpu_torch.ops.king_emit import emit_hits, emit_hits_plain
    from cuking_tpu_torch.ops.king_math import KingCounts, king_from_counts
    from cuking_tpu_torch.utils.synthetic import random_counters, random_planes

    rng = np.random.default_rng(SEED + 5)
    dev = torch.device("cuda", 0)
    planes = torch.from_numpy(
        random_planes(2048, PlaneLayout.create(SITES), rng).view(np.int32)).to(dev)
    off = panel_counts_cuda_indexed(planes, 0, 1024, 0, 1024)
    tri = panel_counts_cuda_indexed(planes, 1024, 1024, 1, 1024)
    ties = ((2, 20), (3, 25), (4, 28))
    rand = KingCounts(*torch.from_numpy(random_counters(1000, 700, rng, ties)).to(dev).unbind(0))
    tie = float(king_from_counts(rand).kin[ties[0]])
    median = float(king_from_counts(off).kin.median())
    check(np.isfinite(tie), "the tied kin is not finite")
    # name, counters, gi_base, gj_base, i_limit, j_limit, threshold, strict,
    # sym, capacity
    cases = [
        ("count kernel's counters off the diagonal, kin > its median", off,
         0, 1024, 1024, 2048, median, True, False, 1 << 20),
        ("a tri diagonal pair (its lower tiles unwritten), strict, keep-all", tri,
         1024, 1024, 2048, 2048, -2.0, True, False, 1 << 20),
        ("limits inside the block (1000 x 900 of 1024 x 1024), keep-all", off,
         0, 1024, 1000, 1924, -2.0, True, False, 1 << 20),
        ("random counters, NaN/-inf rows, 3 pairs at the threshold, strict and sym "
         "across the diagonal", rand, 100, 90, 1100, 1100, tie, True, True, 1 << 20),
        ("random counters, sym only, rectangular limits, keep-all", rand,
         5000, 40, 5900, 700, -2.0, False, True, 1 << 20),
        ("keep-all 1024 x 1024 into 1000 slots: overflow, exact count", off,
         0, 1024, 1024, 2048, -2.0, True, False, 1000),
    ]
    max_err = 0
    for name, counts, gi, gj, il, jl, threshold, strict, sym, capacity in cases:
        args = (gi, gj, il, jl, threshold, strict, sym)
        got = HitBuffer(capacity, dev)
        emit_hits(counts, got, *args)
        ref = HitBuffer(1 << 21, dev)
        emit_hits_plain(counts, ref, *args)
        torch.cuda.synchronize()
        max_err = max(max_err, compare_emits(got, ref, name))
        total = int(got.count)
        if threshold == tie:
            kin_bits = got.rows(total)[2]
            check(not (kin_bits == np.float32(tie).view(np.int32)).any(),
                  f"{name}: a pair at the threshold passed")
        check(total > 0, f"{name}: no hits")
        say(f"phase 2b: {name}: {total} hits"
            f"{f' ({capacity} kept)' if total > capacity else ''}, the same count and "
            f"rows as the plain version")

    # Times at the engine's shape, off the diagonal.  The launches cycle over
    # four counter blocks (100 MB, twice the L2), so each reads device memory.
    blocks = [panel_counts_cuda_indexed(planes, 0, 1024, 0, 1024) for _ in range(4)]
    del off, tri, rand
    iters, warmup = 40, 4
    pairs = 1024 * 1024

    def timed(fn, threshold, n_iters, n_warmup, timer):
        hits = HitBuffer(pairs * (n_iters + n_warmup), dev)  # room for keep-all
        cycle = itertools.cycle(blocks)
        ms = timer(lambda: fn(next(cycle), hits, 0, 1024, 1024, 2048, threshold,
                              True, False), n_iters, n_warmup)
        return ms, int(hits.count) // (n_iters + n_warmup)

    t = {}
    (t["ms"], t["host_ms"]), hit_free = timed(emit_hits, 0.0884, iters, warmup, queued_ms)
    (t["keep_all_ms"], _), keep_all = timed(emit_hits, -2.0, iters, warmup, queued_ms)
    t["plain_ms"], _ = timed(emit_hits_plain, 0.0884, 3, 1, cuda_ms)
    t["plain_keep_all_ms"], _ = timed(emit_hits_plain, -2.0, 3, 1, cuda_ms)
    check(hit_free == 0 and keep_all > 0.99 * pairs,
          f"the timed runs had {hit_free} and {keep_all} hits per launch")
    t["bound_ms"], t["bound_by"] = emit_bound(pairs, hit_free)
    t["keep_all_bound_ms"], _ = emit_bound(pairs, keep_all)
    del blocks
    torch.cuda.empty_cache()
    say(f"phase 2b: emit 1024x1024 pairs: kernel hit-free {t['ms'] * 1e3:.1f} us "
        f"(bound {t['bound_ms'] * 1e3:.1f} us), keep-all {t['keep_all_ms'] * 1e3:.1f} us "
        f"(bound {t['keep_all_bound_ms'] * 1e3:.1f} us); the host's time per launch "
        f"{t['host_ms'] * 1e3:.1f} us; plain version hit-free "
        f"{t['plain_ms']:.3f} ms, keep-all {t['plain_keep_all_ms']:.3f} ms ({card})")
    return {"max_abs_err": max_err, **t, "library_ms": None}


def phase_engine(card: str):
    import torch

    from cuking_tpu_torch.models import king as king_model
    from cuking_tpu_torch.models.king import KingConfig, KingEngine
    from cuking_tpu_torch.utils.stopwatch import StageLogger
    from tools.torch_sweep_ab import cell_a_storage

    storage, planted = cell_a_storage()
    n = storage.submatrix.num_rows
    expected = {(a, b): defined_sites(storage.planes, a) for a, b in planted}

    cfg = KingConfig(kernel="cuda", device="cuda")
    engine = KingEngine(storage, cfg, logger=StageLogger(stream=sys.stderr))
    engine.planes_dev  # upload outside the timed sweep
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t = time.perf_counter()
    rs = engine.run()
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t
    launches = read_launches("the engine")

    got = {(int(i), int(j)) for i, j in zip(rs.i_idx, rs.j_idx)}
    check(got == set(expected), f"engine returned {len(got)} pairs, expected the 64 planted")
    check(bool(np.all(rs.kin.view(np.uint32) == np.float32(0.5).view(np.uint32))),
          "planted kin is not float32(0.5)")
    check(bool(np.all(rs.ibs0 == 0) and np.all(rs.ibs1 == 0)), "planted ibs0/ibs1 not 0")
    for i, j, ibs2 in zip(rs.i_idx, rs.j_idx, rs.ibs2):
        check(int(ibs2) == expected[(int(i), int(j))], f"ibs2 of ({i}, {j})")
    steps = len(engine._panel_pair_params())
    check(launches == {k: steps for k in KERNELS}, f"{launches} launches in {steps} steps")
    pairs = n * (n - 1) // 2
    peak = torch.cuda.max_memory_allocated()
    say(f"phase 3: {n} x {SITES} engine: exactly the 64 planted pairs, kin == 0.5, "
        f"ibs2 == defined sites; {launches} kernel launches")
    say(f"phase 3: sweep {sweep_s:.3f} s, {pairs / sweep_s:,.0f} pairs/s, "
        f"peak device memory {peak / 2**20:.0f} MiB ({card})")

    # The step loop again, where any call that waits for the device raises;
    # the deliberate waits for the count copies a window back
    # (HitBuffer.wait_oldest, on a CUDA event) are counted.
    torch.cuda.synchronize()
    t = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        hits = engine.sweep(cfg.resolved_result_capacity())
        enqueue_s = time.perf_counter() - t
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(int(hits.count) == len(planted), f"the checked sweep counted {int(hits.count)} hits")
    torch.cuda.synchronize()
    waits = steps // king_model.LIMIT_CHECK_STEPS - king_model.LIMIT_CHECK_WINDOW
    check(hits.waits == waits, f"the sweep waited {hits.waits} times, expected {waits}")
    say(f"phase 3: the step loop under set_sync_debug_mode('error'): no sync in "
        f"{steps} steps but its {hits.waits} deliberate waits for the count copy "
        f"{king_model.LIMIT_CHECK_WINDOW} copies back; the host queued them in "
        f"{enqueue_s:.3f} s, the device finished {time.perf_counter() - t:.3f} s after "
        f"the start ({card})")
    del hits
    profile_sweep(engine, card)
    return launches, storage, rs


def phase_early_stop(card: str, storage) -> dict:
    """Cell A's planes at threshold -2.0: every step's hits pass the default
    max_results within the first 64 steps, so the sweep must raise the JAX
    engine's error with at most (LIMIT_CHECK_WINDOW + 1) x LIMIT_CHECK_STEPS
    steps queued."""
    import torch

    from cuking_tpu_torch.models import king as king_model
    from cuking_tpu_torch.models.king import KingConfig, KingEngine
    from cuking_tpu_torch.utils.status import ResourceExhaustedError
    from cuking_tpu_torch.utils.stopwatch import StageLogger

    engine = KingEngine(storage, KingConfig(kernel="cuda", device="cuda", kin_threshold=-2.0),
                        logger=StageLogger(enabled=False))
    engine.planes_dev
    steps = len(engine._panel_pair_params())
    bound = (king_model.LIMIT_CHECK_WINDOW + 1) * king_model.LIMIT_CHECK_STEPS
    torch.cuda.synchronize()
    reset_launches()
    t = time.perf_counter()
    try:
        engine.run()
        check(False, "the keep-all sweep of cell A did not pass max_results")
    except ResourceExhaustedError as e:
        error_s = time.perf_counter() - t
        check("--max_results" in str(e), f"the error is not the engine's: {e}")
    launches = read_launches("the overflowing engine")
    torch.cuda.synchronize()
    drained_s = time.perf_counter() - t
    check(launches["king_emit"] <= bound < steps,
          f"{launches['king_emit']} of {steps} steps queued before the error, more than "
          f"{bound}")
    say(f"phase 3b: keep-all sweep of cell A past max_results: ResourceExhausted with "
        f"{launches['king_emit']} of {steps} steps queued (at most {bound}), "
        f"{error_s:.3f} s after the start; the device ended {drained_s:.3f} s after it "
        f"({card})")
    return launches


def profile_sweep(engine, card: str) -> None:
    """One more sweep under torch.profiler: the device's busy share (kernel
    time over the sweep's wall time) and the kernels that take the most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        engine.run()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t)
    per_kernel: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            name = e.name if len(e.name) < 60 else e.name[:57] + "..."
            n, us = per_kernel.get(name, (0, 0.0))
            per_kernel[name] = (n + 1, us + e.time_range.elapsed_us())
    busy_us = sum(us for _, us in per_kernel.values())
    if not busy_us:
        say("phase 3: profiled sweep: the profiler saw no device time (busy share not "
            "measured)")
        return
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:4]
    say(f"phase 3: profiled sweep {wall_us / 1e6:.3f} s, device busy "
        f"{100 * busy_us / wall_us:.1f}% ({busy_us / 1e6:.3f} s of kernels); " + "; ".join(
            f"{name}: {n} x {us / n / 1e3:.3f} ms = {100 * us / busy_us:.1f}%"
            for name, (n, us) in top) + f" ({card})")


def phase_keep_all(card: str):
    import torch

    import io

    from cuking_tpu_torch.models import king as king_model
    from cuking_tpu_torch.models.king import KingConfig, KingEngine, PanelStorage
    from cuking_tpu_torch.ops.bitset import PlaneLayout
    from cuking_tpu_torch.ops.king_emit import emit_hits_plain
    from cuking_tpu_torch.parallel.submatrix import Submatrix
    from cuking_tpu_torch.utils.stopwatch import StageLogger
    from cuking_tpu_torch.utils.synthetic import fill_random_planes

    n = 4096
    rng = np.random.default_rng(SEED + 2)
    layout = PlaneLayout.create(SITES)
    storage = PanelStorage(layout, Submatrix.create(n, 1, 0), 1024)
    fill_random_planes(storage.planes, layout, rng)
    results, times, launches = {}, {}, {}
    # The cuda engine, the matmul engine (its counters are stacked for the
    # emit kernel), and the cuda engine with the emit kernel's plain version.
    for run in ("cuda", "matmul", "cuda, plain emit"):
        log = io.StringIO()
        engine = KingEngine(storage, KingConfig(kernel=run.split(",")[0], device="cuda",
                                                kin_threshold=-2.0),
                            logger=StageLogger(stream=log))
        engine.planes_dev
        torch.cuda.synchronize()
        emit = king_model.emit_hits
        if run.endswith("plain emit"):
            king_model.emit_hits = emit_hits_plain
        try:
            reset_launches()
            t = time.perf_counter()
            results[run] = engine.run()
            times[run] = time.perf_counter() - t
            # The matmul engine counts through plain PyTorch products.
            path_kernels = {"cuda": KERNELS, "matmul": ("king_emit",)}.get(run)
            if path_kernels:
                launches = add_launches(
                    launches, read_launches(f"the {run} keep-all engine", path_kernels))
        finally:
            king_model.emit_hits = emit
        check("re-running at capacity 8388608" in log.getvalue(),
              f"the {run} keep-all engine did not re-run at 2^23 slots")
    a = results["cuda"]
    check(len(a) == n * (n - 1) // 2, f"keep-all gave {len(a)} hits")
    for run in ("matmul", "cuda, plain emit"):
        same_results(results[run], a, f"keep-all {run} engine vs the cuda engine")
    say(f"phase 4: keep-all {n} x {SITES}: {len(a)} hits past 2^20 slots, each sweep "
        f"re-ran at 2^23; the cuda engine, the matmul engine and the cuda engine with "
        f"the plain emit are identical (sweeps incl. the re-run and the sort: "
        + ", ".join(f"{run} {s:.3f} s" for run, s in times.items()) + f", {card})")
    return launches, storage, a


def _rows(output_uri: str) -> list:
    from cuking_tpu_torch.io.uri import Storage
    from cuking_tpu_torch.io.writer import read_results_table

    t = read_results_table(Storage(), output_uri)
    kin_bits = np.asarray(t.column("kin").to_numpy(), np.float32).view(np.uint32)
    cols = [t.column(c).to_pylist() for c in ("i", "j", "ibs0", "ibs1", "ibs2")]
    return sorted(zip(cols[0], cols[1], kin_bits.tolist(), *cols[2:]))


def phase_cli(tmp: str):
    import pyarrow  # noqa: F401  (the GPU machine has it; its absence fails)

    from cuking_tpu_torch import cli
    from cuking_tpu_torch.io.synthetic_input import write_synthetic_input
    from cuking_tpu_torch.io.uri import Storage
    from cuking_tpu_torch.utils.synthetic import random_genotypes

    g = random_genotypes(1000, 10_000, missing_rate=0.05, seed=SEED,
                         num_related_pairs=5)
    inp = f"{tmp}/in.parquet"
    write_synthetic_input(Storage(), inp, g)

    reset_launches()
    run_cli(inp, f"{tmp}/split1", "--device", "cuda")
    for shard in range(3):
        run_cli(inp, f"{tmp}/split2", "--device", "cuda", "--split_factor", "2",
                "--shard_index", str(shard))
    launches = read_launches("the CLI")
    run_cli(inp, f"{tmp}/cpu", "--device", "cpu", "--kernel", "matmul")
    split1, split2, cpu = (_rows(f"{tmp}/{d}") for d in ("split1", "split2", "cpu"))
    check(len(split1) >= 5, f"CLI found {len(split1)} related pairs, expected >= 5")
    check(split2 == split1, "merged split-2 shards differ from the split-1 run")
    check(cpu == split1, "the cuda run differs from the CPU plain-path run")
    say(f"phase 5: CLI 1000 x 10000: {len(split1)} rows; split 2 merged == split 1 "
        f"== --device cpu --kernel matmul, bit for bit; {launches} kernel launches")
    return launches, inp, split1


def run_cli(inp: str, out: str, *extra) -> None:
    from cuking_tpu_torch import cli

    rc = cli.main(["--input_uri", inp, "--output_uri", out, "--quiet", *extra])
    check(rc == 0, f"cli {' '.join(extra)} exited {rc}")


def same_results(got, ref, what: str) -> None:
    check(len(got) == len(ref), f"{what}: {len(got)} rows, expected {len(ref)}")
    for f in ("i_idx", "j_idx", "ibs0", "ibs1", "ibs2"):
        check(np.array_equal(getattr(got, f), getattr(ref, f)), f"{what}: {f} differs")
    check(np.array_equal(got.kin.view(np.uint32), ref.kin.view(np.uint32)),
          f"{what}: kin bits differ")


def ring_kw(**kw) -> dict:
    from cuking_tpu_torch.ops.king_cuda import panel_counts_cuda, panel_counts_cuda_indexed

    return dict(kernel=panel_counts_cuda, indexed_kernel=panel_counts_cuda_indexed, **kw)


def phase_ring(card: str, storage, engine_rs) -> dict:
    import torch

    from cuking_tpu_torch.parallel.ring import (
        RingMesh,
        _pad_and_shard,
        all_pairs_presharded,
        ring_output_to_resultset,
    )

    n = storage.submatrix.num_rows
    mesh = RingMesh(["cuda:0"] * 4)
    blocks, nd = _pad_and_shard(storage.planes, n, mesh, 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t = time.perf_counter()
    out = all_pairs_presharded(blocks, n, **ring_kw(mesh=mesh, kin_threshold=0.0884))
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t
    launches = read_launches("the ring")
    rs = ring_output_to_resultset(out)
    same_results(rs, engine_rs, "4-position ring vs engine")
    pairs = n * (n - 1) // 2
    peak = torch.cuda.max_memory_allocated()
    say(f"phase 6: ring of 4 positions on cuda:0 at {n} x {SITES}: exactly the "
        f"engine's {len(rs)} pairs (kin bits, IBS equal); {launches} kernel launches")
    say(f"phase 6: ring sweep {sweep_s:.3f} s, {pairs / sweep_s:,.0f} pairs/s, peak "
        f"device memory {peak / 2**20:.0f} MiB ({card}); the 4 positions share one "
        "card, so this checks correctness and is not a scaling figure")
    return launches


def phase_rings_keep_all(card: str, storage, engine_rs) -> dict:
    import torch

    from cuking_tpu_torch.models.king import PanelStorage, ResultSet
    from cuking_tpu_torch.parallel.ring import (
        RingMesh,
        all_pairs_sharded,
        ring_output_to_resultset,
        submatrix_pairs_sharded,
    )
    from cuking_tpu_torch.parallel.submatrix import Submatrix

    n = storage.submatrix.num_rows
    launches = {}

    def timed(what, fn):
        nonlocal launches
        reset_launches()
        t = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        launches = add_launches(launches, read_launches(what))
        return result, time.perf_counter() - t

    out, t3 = timed("3-position ring", lambda: all_pairs_sharded(
        storage.planes, n, **ring_kw(mesh=RingMesh(["cuda:0"] * 3),
                                     kin_threshold=-2.0, capacity_per_device=1 << 22)))
    same_results(ring_output_to_resultset(out), engine_rs, "3-position ring")

    mesh2 = RingMesh(["cuda:0"] * 2)
    shard_storages = []
    for shard in range(3):
        sm = Submatrix.create(n, 2, shard)
        st = PanelStorage(storage.layout, sm, 1024)
        stored = sm.stored_sample_indices()
        st.planes[:, st.storage_offsets(stored)] = storage.planes[:, stored]
        shard_storages.append(st)
    outs, t_split = timed("split-2 rings", lambda: [
        submatrix_pairs_sharded(st, **ring_kw(mesh=mesh2, kin_threshold=-2.0,
                                              capacity_per_device=1 << 22))
        for st in shard_storages])
    merged = ResultSet.concat_and_sort([ring_output_to_resultset(o) for o in outs])
    same_results(merged, engine_rs, "split-2 shard rings merged")

    retries = []
    for first in (1 << 16, 1 << 21):
        # The planes are uploaded inside the call, so its peak holds them,
        # the hit buffers and a sub-tile's transients.
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out, t_retry = timed(f"retry ring from {first}", lambda: all_pairs_sharded(
            storage.planes, n, **ring_kw(mesh=mesh2, kin_threshold=-2.0,
                                         capacity_per_device=first)))
        peak = torch.cuda.max_memory_allocated() - base
        check(out.capacity_per_device > first, f"the ring did not retry past capacity {first}")
        same_results(ring_output_to_resultset(out), engine_rs, f"auto-retry ring from {first}")
        retries.append(retry_memory(storage, mesh2, first, out.capacity_per_device, peak,
                                    t_retry))
        del out
    say(f"phase 7: keep-all {n} x {SITES} ({len(engine_rs)} hits), each equal to the "
        f"cuda engine: 3-position ring {t3:.3f} s; split-2 shards on 2 positions "
        f"{t_split:.3f} s; " + "; ".join(retries) + f" (sweeps incl. compaction into the "
        f"hit buffers, excl. the copy to the host and the sort; {card}); {launches} "
        "kernel launches")
    return launches


def retry_memory(storage, mesh, first: int, retry: int, peak: int, seconds: float) -> str:
    """Holds a forced ring retry's peak device memory to check_ring_fit's
    model, and, when the first run's hit buffers outweigh two sub-tiles'
    counters (the transients beside them), to one set of hit buffers per
    position: the first set must be freed before the retry's is made."""
    from cuking_tpu_torch.parallel.ring import DEFAULT_MAX_RESULTS
    from cuking_tpu_torch.utils.hbm import ring_shard_bytes

    n, d = storage.submatrix.num_rows, mesh.size
    planes = storage.planes[:, :n].nbytes
    # The retry is capped at the reference's default max_results when the
    # caller gives none, so the model budgets that.
    model = ring_shard_bytes(n, n, True, storage.layout.words, 1024, 1, d, first,
                             DEFAULT_MAX_RESULTS, positions_per_device=d)
    check(peak <= model, f"the retry from {first} peaked at {peak} B, over the model's "
                         f"{model} B")
    first_set, retry_set = d * first * 24, d * retry * 24
    counters = 6 * 4 * 1024 * 1024  # one 1024 x 1024 sub-tile's int32 counters
    if first_set > 2 * counters:
        check(peak < planes + retry_set + first_set,
              f"the retry from {first} peaked at {peak} B: the first run's {first_set} B "
              "of hit buffers were alive beside the retry's")
    return (f"retry from {first} to {retry} slots {seconds:.3f} s, peak device memory "
            f"{peak / 2**20:.1f} MiB (planes {planes / 2**20:.1f}, hit buffers first "
            f"{first_set / 2**20:.1f}, retry {retry_set / 2**20:.1f}; check_ring_fit's "
            f"model {model / 2**20:.1f} MiB)")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# The --distributed child: the CLI's entry point, then its launch counts.
_CHILD = (
    "import sys\n"
    "from cuking_tpu_torch import cli\n"
    "from cuking_tpu_torch.ops import king_cuda, king_emit\n"
    "rc = cli.main(sys.argv[1:])\n"
    "print('LAUNCHES', king_cuda.launches, king_emit.emit_launches)\n"
    "sys.exit(rc)\n"
)


def phase_cli_mesh(tmp: str, inp: str, split1: list) -> dict:
    reset_launches()
    mesh = ["--use_mesh", "--device", "cuda:0,cuda:0"]
    run_cli(inp, f"{tmp}/mesh1", *mesh)
    for shard in range(3):
        run_cli(inp, f"{tmp}/mesh2", *mesh, "--split_factor", "2", "--shard_index", str(shard))
    launches = read_launches("the mesh CLI")
    check(_rows(f"{tmp}/mesh1") == split1, "--use_mesh split 1 differs from phase 5")
    check(_rows(f"{tmp}/mesh2") == split1, "--use_mesh split 2 merged differs from phase 5")

    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, "--input_uri", inp, "--output_uri",
         f"{tmp}/dist", "--distributed", "--device", "cuda:0,cuda:0,cuda:0,cuda:0"],
        cwd=REPO, env=env,
        capture_output=True, text=True, timeout=300,
    )
    check(proc.returncode == 0,
          f"--distributed exited {proc.returncode}:\n{proc.stdout}\n{proc.stderr}")
    child = dict(zip(KERNELS, map(int, proc.stdout.split("LAUNCHES")[-1].split()[:2])))
    check(min(child.values()) > 0, f"the --distributed run's launches: {child}")
    check("rank 0 of 1, 4 ring positions" in proc.stdout,
          "--distributed did not start a world of 1 with 4 positions")
    check(_rows(f"{tmp}/dist") == split1, "--distributed differs from phase 5")
    say(f"phase 8: --use_mesh on 2 positions (split 1; split 2 merged) and "
        f"--distributed (NCCL, world 1, 4 positions on cuda:0) == phase 5's "
        f"{len(split1)} rows, bit for bit; {launches} + {child} kernel launches")
    return add_launches(launches, child)


def phase_king_popcount(card: str):
    import torch

    from cuking_tpu_torch import KingConfig, KingEngine, king
    from cuking_tpu_torch.ops import king_cuda, king_emit
    from cuking_tpu_torch.ops.king_mm import panel_counts_matmul

    rng = np.random.default_rng(SEED + 3)
    g = rng.integers(-1, 3, size=(2048, SITES), dtype=np.int8)
    g[7] = g[1000]                      # a duplicate: kin 0.5
    g[11] = -1                          # all missing: NaN kin
    g[12] = np.where(g[12] == 1, 2, g[12])  # no hets: -inf kin
    reset_launches()
    t = time.perf_counter()
    got = king(g, device="cuda")
    torch.cuda.synchronize()
    king_s = time.perf_counter() - t
    launches = {"king_counts": king_cuda.launches, "king_emit": king_emit.emit_launches}
    check(launches["king_counts"] > 0, "king() launched no count kernel")
    check(launches["king_emit"] == 0, "king() is dense: it emits nothing")
    ref = king(g, kernel=lambda a, b: panel_counts_matmul(a, b), device="cuda")
    check(torch.equal(got.kin.view(torch.int32), ref.kin.view(torch.int32)),
          "king(): kin bits differ from the plain version")
    for f in ("ibs0", "ibs1", "ibs2"):
        check(torch.equal(getattr(got, f), getattr(ref, f)), f"king(): {f} differs")
    kin = got.kin.cpu().numpy()
    check(kin[7, 1000] == np.float32(0.5), "king(): the duplicate is not kin 0.5")
    check(bool(np.isnan(kin[11]).all()), "king(): the all-missing sample is not NaN")
    check(bool(np.isneginf(kin[12, 13:]).any()), "king(): the het-free sample has no -inf")
    say(f"phase 9: king() {len(g)} x {SITES} on cuda equals the plain version on the "
        f"card (kin bits incl. NaN/-inf, IBS); {king_s:.3f} s incl. packing; "
        f"{launches} kernel launch ({card})")

    from cuking_tpu_torch.utils.synthetic import random_genotypes

    g2 = random_genotypes(1024, 10_000, missing_rate=0.05, seed=SEED, num_related_pairs=5)
    runs = {}
    for kernel in ("popcount", "cuda"):
        cfg = KingConfig(kernel=kernel, device="cuda", kin_threshold=-2.0)
        reset_launches()
        t = time.perf_counter()
        runs[kernel] = KingEngine.from_genotypes(g2, cfg).run()
        runs[kernel + "_s"] = time.perf_counter() - t
        check(king_emit.emit_launches > 0, f"the {kernel} engine launched no emit kernel")
        launches["king_emit"] += king_emit.emit_launches
        launches["king_counts"] += king_cuda.launches
    same_results(runs["popcount"], runs["cuda"], "popcount engine vs cuda engine")
    say(f"phase 9: popcount engine {g2.shape[0]} x {g2.shape[1]} keep-all == cuda engine "
        f"({len(runs['cuda'])} hits; popcount {runs['popcount_s']:.3f} s, cuda "
        f"{runs['cuda_s']:.3f} s, {card}); {launches} kernel launches")
    return launches


def _stage_seconds(log: str, message: str) -> float:
    """The seconds a stage took, from the CLI's stage log line
    ``<message>...<dots> (<seconds>s)``."""
    m = re.search(re.escape(message) + r"[^\n]*?\.\.\.\.*\s*\(([0-9.]+)s\)", log)
    check(m is not None, f"no '{message}' stage in the task's log")
    return float(m.group(1))


# The kernels' names in a trace, by the name of their launch counters.
TRACE_NAMES = {"king_counts": "king_counts_wgmma_kernel", "king_emit": "king_emit_kernel"}


def trace_summary(path: str) -> tuple[dict, float, float]:
    """(launches of each kernel, device busy ms, traced span ms) of a
    Chrome trace written by ``--profile_dir``; busy counts kernels, copies
    and memsets on the device."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    check(bool(events), f"{path} holds no events")
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    launches = {k: sum(1 for e in device if e["cat"] == "kernel" and name in e["name"])
                for k, name in TRACE_NAMES.items()}
    busy_us = sum(float(e["dur"]) for e in device)
    start = min(float(e["ts"]) for e in events)
    end = max(float(e["ts"]) + float(e.get("dur", 0)) for e in events)
    return launches, busy_us / 1e3, (end - start) / 1e3


def phase_fan_out(tmp: str, card: str) -> dict:
    import contextlib
    import io

    from cuking_tpu_torch.cloud import batch_submit
    from cuking_tpu_torch.io.synthetic_input import write_synthetic_input
    from cuking_tpu_torch.io.uri import Storage
    from cuking_tpu_torch.utils.synthetic import random_genotypes

    n = 2048
    g = random_genotypes(n, SITES, missing_rate=0.05, seed=SEED + 4, num_related_pairs=4)
    entries = int(np.count_nonzero(g >= 0))
    inp, out, traces = f"{tmp}/fan_in.parquet", f"{tmp}/fan_out", f"{tmp}/fan_traces"
    t = time.perf_counter()
    write_synthetic_input(Storage(), inp, g, num_partitions=4)
    write_s = time.perf_counter() - t
    del g
    say(f"phase 10: wrote {n} x {SITES} ({entries:,} Parquet entries, 4 partitions) "
        f"in {write_s:.1f} s")

    def render(output_uri: str, *extra: str) -> dict:
        rendered = io.StringIO()
        with contextlib.redirect_stdout(rendered):
            rc = batch_submit.main([
                "--input-uri", inp, "--output-uri", output_uri,
                "--kin-threshold", "0.0884", "--split-factor", "2",
                "--docker-image", "cuking_tpu_torch:smoke", "--render-only", *extra,
            ])
        check(rc == 0, f"batch_submit --render-only exited {rc}")
        return json.loads(rendered.getvalue())

    job = render(out, f"--cuking-arg=--profile_dir={traces}")
    group = job["taskGroups"][0]
    check(group["taskCount"] == 3, f"split 2 rendered {group['taskCount']} tasks")
    instance = job["allocationPolicy"]["instances"][0]
    check(instance["policy"]["accelerators"] == [{"type": "nvidia-h100-80gb", "count": 1}]
          and instance["installGpuDrivers"] is True, "the job has no H100 accelerator block")
    container = group["taskSpec"]["runnables"][0]["container"]
    check(container["entrypoint"] == "/bin/sh" and container["commands"][0] == "-c",
          "the task does not run under /bin/sh -c")
    command = container["commands"][1]
    plain_out = f"{tmp}/fan_out_plain"
    plain_command = render(plain_out)["taskGroups"][0]["taskSpec"]["runnables"][0][
        "container"]["commands"][1]

    # The tasks' python3 is this interpreter, as the image's is its own.
    path = os.pathsep.join([os.path.dirname(sys.executable), os.environ.get("PATH", "")])

    def run_task(cmd: str, k: int) -> tuple[float, str]:
        t = time.perf_counter()
        proc = subprocess.run(["/bin/sh", "-c", cmd], cwd=REPO,
                              env=dict(os.environ, BATCH_TASK_INDEX=str(k), PATH=path),
                              capture_output=True, text=True, timeout=600)
        wall_s = time.perf_counter() - t
        check(proc.returncode == 0,
              f"task {k} exited {proc.returncode}:\n{proc.stdout}\n{proc.stderr}")
        return wall_s, proc.stdout

    def stages(log: str) -> str:
        ingest_s = _stage_seconds(log, "Processing Parquet tables")
        staged_s = sum(map(float, re.findall(r"\(([0-9.]+)s\)\n", log)))
        return (f"ingest {ingest_s:.3f} s ({entries / ingest_s:,.0f} entries/s read), "
                f"all logged stages {staged_s:.3f} s, sweep "
                f"{_stage_seconds(log, 'Running KING kernel for'):.3f} s")

    t = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", "import torch, cuking_tpu_torch.cli; "
         "torch.zeros(1, device='cuda').sum().item()"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    startup_s = time.perf_counter() - t
    check(proc.returncode == 0, f"the start-up probe exited {proc.returncode}:\n{proc.stderr}")
    say(f"phase 10: start-up (python3, import the CLI, CUDA context, exit) "
        f"{startup_s:.3f} s ({card})")

    launches = {}
    for k in range(group["taskCount"]):
        plain_s, log = run_task(plain_command, k)
        say(f"phase 10: task {k} without --profile_dir: exit 0, wall {plain_s:.3f} s, "
            f"{stages(log)} ({card})")
        wall_s, log = run_task(command, k)
        task_launches, busy_ms, span_ms = trace_summary(
            f"{traces}/trace-part-{k:05d}.json")
        for name, n in task_launches.items():
            check(n > 0, f"task {k}: no {TRACE_NAMES[name]} in its trace")
        launches = add_launches(launches, task_launches)
        say(f"phase 10: task {k} with --profile_dir: exit 0, wall {wall_s:.3f} s "
            f"({wall_s - plain_s:+.3f} s against the untraced run), {stages(log)} with "
            f"kernel launches {task_launches}; traced sweep {span_ms:.1f} ms, device "
            f"busy {busy_ms:.3f} ms = {100 * busy_ms / span_ms:.2f}% ({card})")

    state = batch_submit.wait_for_completion(
        "cuking-smoke", location="us-central1", output_uri=out,
        runner=lambda cmd: json.dumps({"status": {"state": "SUCCEEDED"}}),
        sleep=lambda s: None, log=lambda *_: None)
    check(state == "SUCCEEDED" and os.path.isfile(f"{out}/_SUCCESS"),
          "wait_for_completion wrote no _SUCCESS")
    reset_launches()
    run_cli(inp, f"{tmp}/fan_split1", "--device", "cuda")
    read_launches("the split-1 reference run")
    merged, split1 = _rows(out), _rows(f"{tmp}/fan_split1")
    check(len(split1) >= 4, f"split 1 found {len(split1)} related pairs, expected >= 4")
    check(merged == split1, "the merged fan-out partitions differ from the split-1 run")
    check(_rows(plain_out) == split1,
          "the untraced fan-out partitions differ from the split-1 run")
    say(f"phase 10: 3 Batch tasks merged == split-1 CLI ({len(split1)} rows, kin bits), "
        f"traced and untraced; _SUCCESS written; {launches} kernel launches in the "
        "tasks' traces")
    return launches


# Phase 11's cohort: the BASELINE config's 1,000 samples x 100,000 sites.
PARITY_SAMPLES, PARITY_SITES = 1000, 100_000


def phase_parity(card: str) -> dict:
    from tools.torch_baseline_parity import run_parity

    reset_launches()
    t = time.perf_counter()
    result = run_parity(PARITY_SAMPLES, PARITY_SITES, device="cuda",
                        log=lambda line: say(f"phase 11: {line}"))
    launches = read_launches("the baseline parity CLI runs")
    check(result["ok"], f"baseline parity: rows differ from the oracle: "
                        f"{result['differences']}")
    say(f"phase 11: baseline parity {PARITY_SAMPLES} x {PARITY_SITES} through the CLI on "
        f"cuda: {result['pairs_compared_bit_exact']:,} finite-kin pairs bit-exact against "
        f"the numpy oracle ({result['nonfinite_pairs_excluded']:,} nonfinite excluded), "
        f"{result['thresholded_pairs']} thresholded pairs, and the split-4 merge of "
        f"{result['shards']} shards: differences {result['differences']}; "
        f"{time.perf_counter() - t:.1f} s in all ({card}); {launches} kernel launches")
    return launches


def phase_side_copy(card: str) -> None:
    """Phase 12a: the side-stream copy of the ring, forced onto cuda:0,
    delivered while a spin kernel still holds the compute stream."""
    import torch

    from cuking_tpu_torch.ops.bitset import PlaneLayout
    from cuking_tpu_torch.parallel.ring import _SideStreams

    words = PlaneLayout.create(SITES).words
    block = torch.randint(-2**31, 2**31 - 1, (2, 16384, words), dtype=torch.int32,
                          device="cuda:0")
    streams = _SideStreams([block])
    torch.cuda.synchronize()

    def copy_under_spin():
        torch.cuda._sleep(400_000_000)
        spin_done = torch.cuda.current_stream().record_event()
        t = time.perf_counter()
        out, delivered = streams.copy(block, None, block.device)
        delivered.synchronize()
        return out, 1e3 * (time.perf_counter() - t), spin_done.query()

    # The first copy makes the side streams and the receive block, as the
    # ring's first rotation does, before any of its kernels is queued; the
    # second reuses them, as every later rotation does, and must not wait.
    first, first_ms, first_waited = copy_under_spin()
    del first
    streams.release()
    torch.cuda.synchronize()
    out, copy_ms, waited = copy_under_spin()
    check(not waited, "the side-stream copy waited for the compute stream")
    streams.join()
    torch.cuda.synchronize()
    check(torch.equal(out, block), "the side-stream copy differs from its source")
    say(f"phase 12a: a {block.nbytes / 1e6:.0f} MB block copied on the ring's side "
        f"streams: the first copy (new side streams, a new receive block) delivered "
        f"{first_ms:.2f} ms after it was queued, "
        f"{'after' if first_waited else 'before'} the spin kernel on the compute stream "
        f"ended; the second, into the reused block, {copy_ms:.2f} ms after, while the "
        f"spin still held the compute stream ({card})")


def scaling_report(argv: list) -> dict:
    """tools/torch_scaling_bench.py in this process; its JSON line."""
    import contextlib
    import io

    from tools import torch_scaling_bench

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = torch_scaling_bench.main(argv)
    check(rc == 0, f"torch_scaling_bench {' '.join(argv)} exited {rc}")
    return json.loads(out.getvalue().strip().splitlines()[-1])


def phase_scaling_same_card(card: str) -> dict:
    """Phase 12b: the scaling tool with every position on cuda:0."""
    from cuking_tpu_torch.parallel.ring import ring_num_steps
    from tools.torch_scaling_bench import schedule_sub_tiles

    rows = 8192
    reset_launches()
    t = time.perf_counter()
    report = scaling_report(["--same-card", "--devices", "1", "2", "3", "4",
                             "--rows-per-gpu", str(rows)])
    launches = read_launches("the scaling tool on one card")
    results = report["weak_scaling"]
    check([r["devices"] for r in results] == [1, 2, 3, 4], f"swept {results}")
    check(len({r["hits"] for r in results}) == 1, f"hit totals differ across D: {results}")
    for r in results:
        check(r["ring_steps"] == ring_num_steps(r["devices"]), f"ring steps of {r}")
        check(r["sub_tiles"] == schedule_sub_tiles(r["devices"], rows // 1024),
              f"sub-tiles of {r}")
    say(f"phase 12b: scaling tool, {rows} rows per position x {SITES} sites, all on "
        f"cuda:0: {results[0]['hits']} hits at every D, steps and sub-tiles as scheduled; "
        + "; ".join(f"D={r['devices']} median {r['median_s']:.4f} s (min {r['min_s']:.4f}, "
                    f"max {r['max_s']:.4f}), {r['sub_tiles']} sub-tiles" for r in results)
        + f"; {time.perf_counter() - t:.1f} s in all ({card}); {launches} kernel launches")
    return launches


def phase_cards(card: str, storage, engine_rs) -> dict:
    """Phase 12c: the ring with one position per card, when there are
    several cards; on one card it says that it did not run."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from cuking_tpu_torch.parallel.ring import (
        DEFAULT_MAX_RESULTS,
        RingMesh,
        _pad_and_shard,
        all_pairs_presharded,
        ring_output_to_resultset,
    )
    from cuking_tpu_torch.utils.hbm import ring_shard_bytes
    from tools.torch_scaling_bench import covered_share, profiled_intervals

    cards = torch.cuda.device_count()
    if cards < 2:
        say("phase 12c: not run: one card is visible, and the overlap of a rotation "
            "with compute shows only between cards (not measured)")
        return {}
    reset_launches()
    report = scaling_report(["--no-assert"])
    launches = {"scaling_cards": read_launches("the scaling tool over the cards")}
    say(f"phase 12c: scaling tool over {cards} cards: " + "; ".join(
        f"D={r['devices']} median {r['median_s']:.4f} s, "
        f"{r['pairs_per_sec_per_gpu'] / 1e6:.1f}M pairs/s per GPU, efficiency "
        f"{r['efficiency_vs_1dev']:.3f}" for r in report["weak_scaling"])
        + f"; transfer under count-kernel time: {report['overlap']} ({card})")

    n = storage.submatrix.num_rows
    mesh = RingMesh([f"cuda:{k}" for k in range(cards)])
    blocks, nd = _pad_and_shard(storage.planes, n, mesh, 1)

    def sweep():
        out = all_pairs_presharded(blocks, n, **ring_kw(mesh=mesh, kin_threshold=0.0884))
        for k in range(cards):
            torch.cuda.synchronize(k)
        return out

    sweep()  # builds the kernels on every card
    base = []
    for k in range(cards):
        torch.cuda.reset_peak_memory_stats(k)
        base.append(torch.cuda.memory_allocated(k))
    reset_launches()
    t = time.perf_counter()
    out = sweep()
    sweep_s = time.perf_counter() - t
    launches["ring_cards"] = read_launches("the ring over the cards")
    same_results(ring_output_to_resultset(out), engine_rs, f"ring of {cards} cards vs engine")
    model = ring_shard_bytes(n, n, True, storage.layout.words, 1024, 1, cards, 1 << 20,
                             DEFAULT_MAX_RESULTS)
    peaks = [torch.cuda.max_memory_allocated(k) - base[k] for k in range(cards)]
    for k, peak in enumerate(peaks):
        check(peak <= model, f"cuda:{k} peaked at {peak} B, over the model's {model} B")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sweep()
    overlap = covered_share(profiled_intervals(prof))
    block_mb = 2 * nd * storage.layout.words * 4 / 2**20
    say(f"phase 12c: cell A ({n} x {SITES}) through a ring of one position per card "
        f"({cards} cards): the engine's {len(engine_rs)} pairs; sweep {sweep_s:.4f} s, "
        f"{n * (n - 1) // 2 / sweep_s:,.0f} pairs/s; peak memory per card "
        + ", ".join(f"{p / 2**20:.1f}" for p in peaks)
        + f" MiB (a block is {block_mb:.1f} MiB; check_ring_fit's model "
        f"{model / 2**20:.1f} MiB); transfer under count-kernel time: {overlap} ({card}); "
        f"{launches} kernel launches")
    return launches


# Phase 14: a whole CLI task from Parquet at 1,000,000 sites.
CLI_SCALE_SAMPLES, CLI_SCALE_FILES = 16_384, 16


def phase_cli_at_scale(card: str) -> dict:
    from tools.torch_cli_at_scale import cohort_for, run_cell

    cohort = cohort_for(CLI_SCALE_SAMPLES, files=CLI_SCALE_FILES)
    with tempfile.TemporaryDirectory() as tmp:
        r = run_cell(cohort, tmp, ingest_runs=0, log=lambda line: say(f"phase 14: {line}"))
    check(r["ok"], f"the CLI task at scale failed its checks: {r['failures']}")
    t = r["task"]
    say(f"phase 14: {cohort.samples:,} x {cohort.sites:,} from {cohort.files} files "
        f"({r['input']['entries']:,} entries): exactly the {r['output']['planted_pairs']:,} "
        f"planted pairs, {t['rows_checked']} rows' planes equal to pack_genotypes, the "
        f"tallies equal, launches {t['launches']}; wall {t['wall_s']:.1f} s ({card})")
    return t["launches"]


# Phase 13: the main path at a deployment's shard size, 1,000,000 sites.
DEPLOY_SITES = 1_000_000
SHARD_ROWS = 69_632  # 68 panels; its het and hom planes cross words 2^31 and 2^32


def compare_panel_pairs(planes, pairs, reference, what: str) -> int:
    """Holds the wgmma kernel's indexed entry against ``reference``
    (``(planes, i_off, j_off) -> KingCounts``) on the 1024 x 1024 panel
    pairs ``pairs`` (name, i_off, j_off, tri) of ``planes``, all six
    counters (only i < j of a ``tri`` pair).  Returns the largest
    difference (0)."""
    import torch

    from cuking_tpu_torch.ops.king_cuda import panel_counts_cuda_indexed

    max_err = 0
    for name, i_off, j_off, tri in pairs:
        got = panel_counts_cuda_indexed(planes, i_off, j_off, tri, 1024)
        ref = reference(planes, i_off, j_off)
        keep = torch.ones((1024, 1024), dtype=torch.bool, device=planes.device).triu(1)
        for k, (g, e) in enumerate(zip(got, ref)):
            if tri:
                g, e = g[keep], e[keep]
            err = int((g.long() - e.long()).abs().max())
            max_err = max(max_err, err)
            check(err == 0, f"{name}: counter {got._fields[k]} differs from {what} by {err}")
    return max_err


def phase_shard(card: str, isolated_1m_ms: float) -> tuple[dict, dict]:
    """Phase 13a: a whole 69,632 x 1,000,000 shard through the engine."""
    import torch

    from cuking_tpu_torch.models.king import KingConfig
    from cuking_tpu_torch.ops.king_cuda import panel_counts_five_block
    from cuking_tpu_torch.utils.synthetic import rows_past_word_limits
    from tools.torch_shard_at_scale import deployment_storage, sweep_and_check

    dev = torch.device("cuda", 0)
    t = time.perf_counter()
    storage, planted = deployment_storage(SHARD_ROWS, DEPLOY_SITES, SEED + 13, dev)
    make_s = time.perf_counter() - t
    words = storage.layout.words
    het_row, hom_row = rows_past_word_limits(SHARD_ROWS, words)
    say(f"phase 13a: {SHARD_ROWS} x {DEPLOY_SITES} ({words} words, "
        f"{storage.planes.size:,} plane words, {storage.planes.nbytes / 1e9:.2f} GB) made "
        f"in {make_s:.1f} s; het rows from {het_row} and hom rows from {hom_row} lie past "
        f"words 2^31 and 2^32; {len(planted)} planted pairs")
    reset_launches()
    engine, r = sweep_and_check(storage, planted, KingConfig(kernel="cuda", device="cuda"))
    launches = read_launches("the 1M-site shard")
    panels = SHARD_ROWS // 1024
    steps = r["steps"]
    check(steps == panels * (panels + 1) // 2, f"{steps} steps")
    check(launches == {k: steps for k in KERNELS}, f"{launches} launches in {steps} steps")
    last = SHARD_ROWS - 1024
    max_err = compare_panel_pairs(
        engine.planes_dev, [("13a last diagonal pair", last, last, 1),
                            ("13a (first, last) pair", 0, last, 0)],
        lambda p, i, j: panel_counts_five_block(p[:, i:i + 1024], p[:, j:j + 1024]),
        "the five-block plain version")
    say(f"phase 13a: exactly the {len(planted)} planted pairs, kin == 0.5, ibs0 == ibs1 == "
        f"0, ibs2 == defined sites, each equal to the numpy oracle; {launches} kernel "
        f"launches; the last diagonal and the (first, last) panel pairs equal the "
        f"five-block plain version on the engine's device planes")
    say(f"phase 13a: upload {r['upload_s']:.2f} s "
        f"({storage.planes.nbytes / r['upload_s'] / 1e9:.1f} GB/s); sweep "
        f"{r['sweep_s']:.3f} s, {r['pairs_per_s']:,.0f} pairs/s, {r['step_ms']:.3f} ms per "
        f"step (phase 2's isolated 1M-site pair {isolated_1m_ms:.3f} ms); peak device memory "
        f"{r['peak_device_bytes'] / 2**20:,.1f} MiB, the model "
        f"{r['model_bytes'] / 2**20:,.1f} MiB ({card})")
    return launches, {"sweep_s": r["sweep_s"], "step_ms": r["step_ms"], "max_abs_err": max_err}


def phase_fit_limit(card: str) -> tuple[dict, int, dict]:
    """Phase 13b: the largest shard at 1,000,000 sites that check_engine_fit
    admits on this card, keep-all into a max_results buffer."""
    import gc

    import torch

    from cuking_tpu_torch.models import king as king_model
    from cuking_tpu_torch.models.king import DEFAULT_MAX_RESULTS, KingConfig, KingEngine
    from cuking_tpu_torch.ops.bitset import PlaneLayout
    from cuking_tpu_torch.ops.king_cuda import (
        panel_counts_cuda_indexed,
        panel_counts_popc_indexed,
    )
    from cuking_tpu_torch.parallel.submatrix import Submatrix
    from cuking_tpu_torch.utils.hbm import check_engine_fit
    from cuking_tpu_torch.utils.status import ResourceExhaustedError
    from cuking_tpu_torch.utils.stopwatch import StageLogger
    from tools.torch_shard_at_scale import (
        deployment_storage,
        fit_limit_rows,
        peak_within_model,
        rss_bytes,
        timed_upload,
    )

    dev = torch.device("cuda", 0)
    gc.collect()
    torch.cuda.empty_cache()
    default = KingConfig(device="cuda")
    size = fit_limit_rows(dev, default)
    rows, limit = size["rows"], size["bytes_limit"]
    check(rows > 0, "not one panel fits")
    say(f"phase 13b: the card's free memory {size['free_bytes']:,} B of "
        f"{size['total_bytes']:,} B, usable {limit:,} B; the host's available memory "
        f"{size['host_available_bytes'] / 2**30:.1f} GiB (settled after "
        f"{size['host_settle_s']:.1f} s) holds {size['host_rows']:,} rows of planes; " + (
            f"check_engine_fit admits {rows:,} rows" if size["rows_set_by"] == "card" else
            f"the host, not the card, set the size: {rows:,} rows"))
    words = PlaneLayout.create(DEPLOY_SITES).words
    check_engine_fit(rows, words, Submatrix.create(rows, 1, 0), default, 1,
                     bytes_limit=limit)
    t = time.perf_counter()
    storage, _ = deployment_storage(rows, DEPLOY_SITES, SEED + 14, dev, families=False)
    make_s = time.perf_counter() - t
    cfg = KingConfig(kernel="cuda", device="cuda", kin_threshold=-2.0,
                     result_capacity=DEFAULT_MAX_RESULTS)
    engine = KingEngine(storage, cfg, logger=StageLogger(enabled=False))
    up = timed_upload(engine)
    upload_s, rss_before, rss_after = up["upload_s"], up["rss_before"], up["rss_after"]
    steps = len(engine._panel_pair_params())
    bound = (king_model.LIMIT_CHECK_WINDOW + 1) * king_model.LIMIT_CHECK_STEPS
    reset_launches()
    t = time.perf_counter()
    try:
        engine.run()
        check(False, "the keep-all sweep of the fit-limit shard did not pass max_results")
    except ResourceExhaustedError as e:
        error_s = time.perf_counter() - t
        check("--max_results" in str(e), f"the error is not the engine's: {e}")
    launches = read_launches("the fit-limit shard")
    torch.cuda.synchronize()
    drained_s = time.perf_counter() - t
    check(launches["king_emit"] <= bound < steps,
          f"{launches['king_emit']} of {steps} steps queued before the error, more than "
          f"{bound}")
    peak, model = peak_within_model(engine, up["base"])
    free_after = torch.cuda.mem_get_info(dev)[0]

    # The last panel pairs on the same device planes: the kernel against the
    # AND + popcount yardstick, and against the oracle on sampled pairs.
    planes = engine.planes_dev
    last = rows - 1024
    pairs = [("13b last diagonal pair", last, last, 1), ("13b (first, last) pair", 0, last, 0)]
    max_err = compare_panel_pairs(
        planes, pairs, lambda p, i, j: panel_counts_popc_indexed(p, i, j, 0, 1024),
        "the AND + popcount yardstick")
    rng = np.random.default_rng(SEED + 14)
    corners = [(0, 1), (0, 63), (0, 1023), (127, 128), (127, 191), (1022, 1023), (128, 1023),
               (511, 512), (895, 960)]
    sampled = 0
    for name, i_off, j_off, tri in pairs:
        cells = corners + ([] if tri else [(1023, 0), (1023, 1023), (64, 63), (1023, 512)])
        cells += [tuple(sorted(p)) if tri else tuple(p)
                  for p in rng.integers(0, 1024, (32, 2)).tolist() if not tri or p[0] != p[1]]
        check_oracle_pairs(panel_counts_cuda_indexed(planes, i_off, j_off, tri, 1024),
                           storage.planes, i_off, storage.planes, j_off, storage.layout,
                           cells, name)
        sampled += len(cells)
    del planes, engine
    rss_peak = rss_bytes()[1]
    planes_term = 74_096 << 20  # cloud/batch_submit.py's memory comment
    say(f"phase 13b: {rows:,} x {DEPLOY_SITES:,} ({storage.planes.nbytes / 1e9:.2f} GB of "
        f"planes) made in {make_s:.1f} s, uploaded through planes_dev in {upload_s:.2f} s "
        f"({storage.planes.nbytes / upload_s / 1e9:.1f} GB/s; host RSS {rss_before[0] / 2**20:,.0f} "
        f"MiB before, {rss_after[0] / 2**20:,.0f} MiB after, peak {rss_after[1] / 2**20:,.0f} MiB)")
    say(f"phase 13b: keep-all into {DEFAULT_MAX_RESULTS:,} slots: ResourceExhausted with "
        f"{launches['king_emit']} of {steps:,} steps queued (at most {bound}), "
        f"{error_s:.3f} s after the start, the device ended {drained_s:.3f} s after it; no "
        f"out-of-memory error; peak device memory {peak / 2**20:,.1f} MiB, the model "
        f"{model / 2**20:,.1f} MiB (planes + {(model - storage.planes.nbytes) / 2**20:,.1f}), "
        f"{(limit - peak) / 2**20:,.1f} MiB of the usable limit and {free_after / 2**20:,.1f} "
        f"MiB free left ({card})")
    say(f"phase 13b: the last diagonal and the (first, last) panel pairs equal the AND + "
        f"popcount yardstick on all six counters and the numpy oracle on {sampled} sampled "
        f"pairs; peak host RSS {rss_peak / 2**20:,.0f} MiB against batch_submit.py's "
        f"{planes_term >> 20:,} MiB planes term, {(rss_peak - storage.planes.nbytes) / 2**20:,.0f} "
        f"MiB of it beside the planes against its 8,192 MiB process term")
    return launches, max_err, {"fit_limit_rows": rows, "fit_limit_set_by": size["rows_set_by"]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    try:
        from cuking_tpu_torch.ops import king_cuda
    except ImportError as e:
        print(f"chip_smoke: cannot import the port (run from the repository "
              f"root): {e}", file=sys.stderr)
        return 2
    card = phase_env()
    phase_task_limit(card)  # before this process holds any device memory
    torch.cuda.set_device(0)
    phase_build()
    records = {"king_counts": phase_kernel(card), "king_emit": phase_emit(card)}
    popc_launches = king_cuda.popc_launches
    launches = {}
    launches["engine"], engine_storage, engine_rs = phase_engine(card)
    launches["engine_early_stop"] = phase_early_stop(card, engine_storage)
    launches["engine_keep_all"], keep_storage, keep_rs = phase_keep_all(card)
    with tempfile.TemporaryDirectory() as tmp:
        launches["cli"], inp, split1 = phase_cli(tmp)
        launches["ring"] = phase_ring(card, engine_storage, engine_rs)
        launches["rings_keep_all"] = phase_rings_keep_all(card, keep_storage, keep_rs)
        launches["cli_mesh"] = phase_cli_mesh(tmp, inp, split1)
        launches["king"] = phase_king_popcount(card)
        launches["fan_out"] = phase_fan_out(tmp, card)
    launches["baseline_parity"] = phase_parity(card)
    phase_side_copy(card)
    launches["scaling_same_card"] = phase_scaling_same_card(card)
    launches.update(phase_cards(card, engine_storage, engine_rs))
    check(king_cuda.popc_launches == popc_launches,
          "the AND + popcount yardstick launched on the main path")
    del engine_storage, engine_rs, keep_storage, keep_rs
    t = time.perf_counter()
    launches["shard_1m"], shard = phase_shard(card, records["king_counts"]["at_1m_sites"]["ms"])
    check(king_cuda.popc_launches == popc_launches,
          "the AND + popcount yardstick launched on the main path")
    launches["fit_limit_1m"], fit_err, fit_size = phase_fit_limit(card)
    records["king_counts"]["max_abs_err"] = max(
        records["king_counts"]["max_abs_err"], shard["max_abs_err"], fit_err)
    records["king_counts"]["shard_1m_step_ms"] = shard["step_ms"]
    records["king_counts"].update(fit_size)
    say(f"phase 13: {time.perf_counter() - t:.1f} s ({card})")
    t = time.perf_counter()
    launches["cli_at_scale"] = phase_cli_at_scale(card)
    say(f"phase 14: {time.perf_counter() - t:.1f} s ({card})")
    # The emit kernel replaces no TPU kernel: the JAX package left the step
    # after the count kernel to XLA, and accumulate_hits is its compaction.
    replaces = {"king_counts": "cuking_tpu/ops/king_pallas.py:359",
                "king_emit": "cuking_tpu/ops/compaction.py:95"}
    say(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": f"cuking_tpu_torch/csrc/{name}.cu",
        "replaces": replaces[name],
        "launches": sum(per_path[name] for per_path in launches.values()),
        "launches_by_path": {path: per_path[name] for path, per_path in launches.items()},
        **records[name],
    } for name in KERNELS]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
