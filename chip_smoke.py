#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``cuking_tpu_torch``) once on one NVIDIA GPU.

Run from the repository root with one CUDA device::

    python3 chip_smoke.py

Phases (any failure exits nonzero):

0. Environment: torch/CUDA versions, ``nvcc --version``, the card's name and
   power limit.
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
3. The main path: ``KingEngine`` at 32,768 samples x 100,000 sites with 64
   planted duplicate pairs; exactly those must come out, with kin == 0.5.
   Kernel launch counts are read from this run.
4. Keep-all parity at 4,096 x 100,000 (8,386,560 hits, which grows the
   result buffer): the cuda and matmul engines give identical results.
5. The CLI end to end on a synthetic Parquet input (pyarrow is required):
   split 1, the three shards of split 2 merged, and the CPU plain path, all
   equal.
6. The ring at full width: ``all_pairs_sharded`` over 4 positions, all on
   ``cuda:0``, on phase 3's planes; it must return exactly the engine's
   ResultSet.  The positions share one card, so its time is a check, not a
   scaling figure.
7. Keep-all rings at 4,096 x 100,000 (phase 4's planes): a 3-position ring
   (odd D, no wrap step), the three shards of split 2 on a 2-position mesh
   (offset triangle and rectangular ring), and a forced auto-retry from
   ``capacity_per_device=1<<16``; each must equal phase 4's cuda engine.
8. The CLI on the mesh, on phase 5's input: ``--use_mesh --device
   cuda:0,cuda:0`` at split 1 and split 2 merged, and ``--distributed`` in a
   subprocess (a world of 1 with NCCL, 4 positions on cuda:0); both must
   equal phase 5's split-1 rows.
9. Dense ``king()`` at 2,048 x 100,000 on the card against the plain version
   on the card (kin as uint32 bits, NaN included), and the popcount engine
   at 1,024 x 10,000 against the cuda engine.

Every count of kernel launches is set to 0 just before a path runs and read
just after; the AND + popcount yardstick may launch on no path.  Phase 3
also profiles one more sweep for the device's busy share.  The
second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Stage logs go to stderr.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

SITES = 100_000
SEED = 20261016


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def say(msg: str) -> None:
    print(msg, flush=True)


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


def phase_env() -> str:
    import torch

    say(f"phase 0: python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
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


def phase_build() -> None:
    from cuking_tpu_torch.ops import king_cuda

    t = time.perf_counter()
    log = king_cuda.build()
    say(f"phase 1: built {king_cuda.LIB_PATH} in {time.perf_counter() - t:.1f} s")
    kernel = "?"
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = next((k for k in ("wgmma", "popc") if f"king_counts_{k}_kernel" in line),
                          "?")
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


def phase_kernel(card: str) -> dict:
    import torch

    from cuking_tpu_torch.ops.bitset import PlaneLayout, planes_to_genotypes
    from cuking_tpu_torch.ops.king_cuda import (
        five_block_indicators,
        panel_counts_cuda,
        panel_counts_cuda_indexed,
        panel_counts_five_block,
        panel_counts_popc_indexed,
    )
    from cuking_tpu_torch.ops.king_mm import indicator_planes, panel_counts_matmul
    from cuking_tpu_torch.ops.oracle import oracle_counts
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
        ii, jj = zip(*pairs)
        counts = [c.cpu().numpy() for c in got]
        gi = planes_to_genotypes(pi_np[:, [i_off + int(x) for x in ii]], lay)
        gj = planes_to_genotypes(pj_np_c[:, [j_off + int(y) for y in jj]], lay)
        for n, (x, y) in enumerate(zip(ii, jj)):
            exp = oracle_counts(gi[n:n + 1], gj[n:n + 1])
            for k, e in enumerate(exp):
                check(int(counts[k][x, y]) == int(e[0, 0]),
                      f"{name}: oracle pair ({x}, {y}): counter {got._fields[k]}")
        say(f"phase 2: {name}: six counters equal the five-block and 9-block plain "
            f"versions (kernel and AND+popc kernel) and {len(ii)} oracle pairs")

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


def phase_engine(card: str):
    import torch

    from cuking_tpu_torch.models.king import KingConfig, KingEngine, PanelStorage
    from cuking_tpu_torch.ops import king_cuda
    from cuking_tpu_torch.ops.bitset import PlaneLayout
    from cuking_tpu_torch.parallel.submatrix import Submatrix
    from cuking_tpu_torch.utils.stopwatch import StageLogger
    from cuking_tpu_torch.utils.synthetic import fill_random_planes

    n = 32_768
    rng = np.random.default_rng(SEED + 1)
    layout = PlaneLayout.create(SITES)
    storage = PanelStorage(layout, Submatrix.create(n, 1, 0), 1024)
    fill_random_planes(storage.planes, layout, rng)
    # 64 planted exact duplicates: 32 inside one panel (diagonal panel
    # pairs), 32 across panels (off-diagonal); every sample in one pair only.
    planted = []
    for k in range(32):
        planted.append((k * 1024 + 10 + k, k * 1024 + 500 + k))
    for k in range(32, 64):
        planted.append(((k - 32) * 1024 + 700 + k, ((k - 25) % 32) * 1024 + 900 + k))
    for a, b in planted:
        storage.planes[:, b] = storage.planes[:, a]
    storage.mark_mutated()
    expected = {(min(a, b), max(a, b)): defined_sites(storage.planes, a)
                for a, b in planted}

    cfg = KingConfig(kernel="cuda", device="cuda")
    engine = KingEngine(storage, cfg, logger=StageLogger(stream=sys.stderr))
    engine.planes_dev  # upload outside the timed sweep
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    king_cuda.launches = 0
    t = time.perf_counter()
    rs = engine.run()
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t
    launches = king_cuda.launches

    got = {(int(i), int(j)) for i, j in zip(rs.i_idx, rs.j_idx)}
    check(got == set(expected), f"engine returned {len(got)} pairs, expected the 64 planted")
    check(bool(np.all(rs.kin.view(np.uint32) == np.float32(0.5).view(np.uint32))),
          "planted kin is not float32(0.5)")
    check(bool(np.all(rs.ibs0 == 0) and np.all(rs.ibs1 == 0)), "planted ibs0/ibs1 not 0")
    for i, j, ibs2 in zip(rs.i_idx, rs.j_idx, rs.ibs2):
        check(int(ibs2) == expected[(int(i), int(j))], f"ibs2 of ({i}, {j})")
    check(launches > 0, "the engine launched no count kernel")
    pairs = n * (n - 1) // 2
    peak = torch.cuda.max_memory_allocated()
    say(f"phase 3: {n} x {SITES} engine: exactly the 64 planted pairs, kin == 0.5, "
        f"ibs2 == defined sites; {launches} kernel launches")
    say(f"phase 3: sweep {sweep_s:.3f} s, {pairs / sweep_s:,.0f} pairs/s, "
        f"peak device memory {peak / 2**20:.0f} MiB ({card})")
    profile_sweep(engine, card)
    return launches, storage, rs


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

    from cuking_tpu_torch.models.king import KingConfig, KingEngine, PanelStorage
    from cuking_tpu_torch.ops import king_cuda
    from cuking_tpu_torch.ops.bitset import PlaneLayout
    from cuking_tpu_torch.parallel.submatrix import Submatrix
    from cuking_tpu_torch.utils.synthetic import fill_random_planes

    n = 4096
    rng = np.random.default_rng(SEED + 2)
    layout = PlaneLayout.create(SITES)
    storage = PanelStorage(layout, Submatrix.create(n, 1, 0), 1024)
    fill_random_planes(storage.planes, layout, rng)
    results, times, launches = {}, {}, 0
    for kernel in ("cuda", "matmul"):
        engine = KingEngine(storage, KingConfig(kernel=kernel, device="cuda",
                                                kin_threshold=-2.0))
        engine.planes_dev
        torch.cuda.synchronize()
        king_cuda.launches = 0
        t = time.perf_counter()
        results[kernel] = engine.run()
        times[kernel] = time.perf_counter() - t
        launches += king_cuda.launches
    a, b = results["cuda"], results["matmul"]
    check(len(a) == n * (n - 1) // 2, f"keep-all gave {len(a)} hits")
    for f in ("i_idx", "j_idx", "ibs0", "ibs1", "ibs2"):
        check(np.array_equal(getattr(a, f), getattr(b, f)), f"keep-all {f} differs")
    check(np.array_equal(a.kin.view(np.uint32), b.kin.view(np.uint32)),
          "keep-all kin bits differ")
    say(f"phase 4: keep-all {n} x {SITES}: {len(a)} hits, cuda and matmul engines "
        f"identical (sweep incl. sort: cuda {times['cuda']:.3f} s, matmul "
        f"{times['matmul']:.3f} s, {card})")
    check(launches > 0, "the keep-all engine launched no count kernel")
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
    from cuking_tpu_torch.ops import king_cuda
    from cuking_tpu_torch.utils.synthetic import random_genotypes

    g = random_genotypes(1000, 10_000, missing_rate=0.05, seed=SEED,
                         num_related_pairs=5)
    inp = f"{tmp}/in.parquet"
    write_synthetic_input(Storage(), inp, g)

    king_cuda.launches = 0
    run_cli(inp, f"{tmp}/split1", "--device", "cuda")
    for shard in range(3):
        run_cli(inp, f"{tmp}/split2", "--device", "cuda", "--split_factor", "2",
                "--shard_index", str(shard))
    launches = king_cuda.launches
    run_cli(inp, f"{tmp}/cpu", "--device", "cpu", "--kernel", "matmul")
    split1, split2, cpu = (_rows(f"{tmp}/{d}") for d in ("split1", "split2", "cpu"))
    check(len(split1) >= 5, f"CLI found {len(split1)} related pairs, expected >= 5")
    check(split2 == split1, "merged split-2 shards differ from the split-1 run")
    check(cpu == split1, "the cuda run differs from the CPU plain-path run")
    check(launches > 0, "the CLI launched no count kernel")
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


def phase_ring(card: str, storage, engine_rs) -> int:
    import torch

    from cuking_tpu_torch.ops import king_cuda
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
    king_cuda.launches = 0
    t = time.perf_counter()
    out = all_pairs_presharded(blocks, n, **ring_kw(mesh=mesh, kin_threshold=0.0884))
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t
    launches = king_cuda.launches
    rs = ring_output_to_resultset(out)
    same_results(rs, engine_rs, "4-position ring vs engine")
    check(launches > 0, "the ring launched no count kernel")
    pairs = n * (n - 1) // 2
    peak = torch.cuda.max_memory_allocated()
    say(f"phase 6: ring of 4 positions on cuda:0 at {n} x {SITES}: exactly the "
        f"engine's {len(rs)} pairs (kin bits, IBS equal); {launches} kernel launches")
    say(f"phase 6: ring sweep {sweep_s:.3f} s, {pairs / sweep_s:,.0f} pairs/s, peak "
        f"device memory {peak / 2**20:.0f} MiB ({card}); the 4 positions share one "
        "card, so this checks correctness and is not a scaling figure")
    return launches


def phase_rings_keep_all(card: str, storage, engine_rs) -> int:
    import torch

    from cuking_tpu_torch.models.king import PanelStorage, ResultSet
    from cuking_tpu_torch.ops import king_cuda
    from cuking_tpu_torch.parallel.ring import (
        RingMesh,
        all_pairs_sharded,
        ring_output_to_resultset,
        submatrix_pairs_sharded,
    )
    from cuking_tpu_torch.parallel.submatrix import Submatrix

    n = storage.submatrix.num_rows
    launches = 0

    def timed(what, fn):
        nonlocal launches
        king_cuda.launches = 0
        t = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        launches += king_cuda.launches
        check(king_cuda.launches > 0, f"{what}: no count kernel launched")
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

    out, t_retry = timed("retry ring", lambda: all_pairs_sharded(
        storage.planes, n, **ring_kw(mesh=mesh2, kin_threshold=-2.0,
                                     capacity_per_device=1 << 16)))
    check(out.capacity_per_device > 1 << 16, "the ring did not retry past capacity 2^16")
    same_results(ring_output_to_resultset(out), engine_rs, "auto-retry ring")
    say(f"phase 7: keep-all {n} x {SITES} ({len(engine_rs)} hits), each equal to the "
        f"cuda engine: 3-position ring {t3:.3f} s; split-2 shards on 2 positions "
        f"{t_split:.3f} s; retry from 2^16 to {out.capacity_per_device} slots "
        f"{t_retry:.3f} s (sweeps incl. compaction into the hit buffers, excl. the copy "
        f"to the host and the sort; {card}); {launches} kernel launches")
    return launches


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# The --distributed child: the CLI's entry point, then its launch count.
_CHILD = (
    "import sys\n"
    "from cuking_tpu_torch import cli\n"
    "from cuking_tpu_torch.ops import king_cuda\n"
    "rc = cli.main(sys.argv[1:])\n"
    "print('LAUNCHES', king_cuda.launches)\n"
    "sys.exit(rc)\n"
)


def phase_cli_mesh(tmp: str, inp: str, split1: list) -> int:
    from cuking_tpu_torch.ops import king_cuda

    king_cuda.launches = 0
    mesh = ["--use_mesh", "--device", "cuda:0,cuda:0"]
    run_cli(inp, f"{tmp}/mesh1", *mesh)
    for shard in range(3):
        run_cli(inp, f"{tmp}/mesh2", *mesh, "--split_factor", "2", "--shard_index", str(shard))
    launches = king_cuda.launches
    check(launches > 0, "the mesh CLI launched no count kernel")
    check(_rows(f"{tmp}/mesh1") == split1, "--use_mesh split 1 differs from phase 5")
    check(_rows(f"{tmp}/mesh2") == split1, "--use_mesh split 2 merged differs from phase 5")

    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    proc = subprocess.run(
        [sys.executable, "-c", _CHILD, "--input_uri", inp, "--output_uri",
         f"{tmp}/dist", "--distributed", "--device", "cuda:0,cuda:0,cuda:0,cuda:0"],
        cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
        capture_output=True, text=True, timeout=300,
    )
    check(proc.returncode == 0,
          f"--distributed exited {proc.returncode}:\n{proc.stdout}\n{proc.stderr}")
    child = int(proc.stdout.split("LAUNCHES")[-1].split()[0])
    check(child > 0, "the --distributed run launched no count kernel")
    check("rank 0 of 1, 4 ring positions" in proc.stdout,
          "--distributed did not start a world of 1 with 4 positions")
    check(_rows(f"{tmp}/dist") == split1, "--distributed differs from phase 5")
    say(f"phase 8: --use_mesh on 2 positions (split 1; split 2 merged) and "
        f"--distributed (NCCL, world 1, 4 positions on cuda:0) == phase 5's "
        f"{len(split1)} rows, bit for bit; {launches} + {child} kernel launches")
    return launches + child


def phase_king_popcount(card: str):
    import torch

    from cuking_tpu_torch import KingConfig, KingEngine, king
    from cuking_tpu_torch.ops import king_cuda
    from cuking_tpu_torch.ops.king_mm import panel_counts_matmul

    rng = np.random.default_rng(SEED + 3)
    g = rng.integers(-1, 3, size=(2048, SITES), dtype=np.int8)
    g[7] = g[1000]                      # a duplicate: kin 0.5
    g[11] = -1                          # all missing: NaN kin
    g[12] = np.where(g[12] == 1, 2, g[12])  # no hets: -inf kin
    king_cuda.launches = 0
    t = time.perf_counter()
    got = king(g, device="cuda")
    torch.cuda.synchronize()
    king_s = time.perf_counter() - t
    launches = king_cuda.launches
    check(launches > 0, "king() launched no count kernel")
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
        t = time.perf_counter()
        runs[kernel] = KingEngine.from_genotypes(g2, cfg).run()
        runs[kernel + "_s"] = time.perf_counter() - t
    same_results(runs["popcount"], runs["cuda"], "popcount engine vs cuda engine")
    say(f"phase 9: popcount engine {g2.shape[0]} x {g2.shape[1]} keep-all == cuda engine "
        f"({len(runs['cuda'])} hits; popcount {runs['popcount_s']:.3f} s, cuda "
        f"{runs['cuda_s']:.3f} s, {card})")
    return launches


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
    torch.cuda.set_device(0)
    card = phase_env()
    phase_build()
    record = phase_kernel(card)
    popc_launches = king_cuda.popc_launches
    launches = {}
    launches["engine"], engine_storage, engine_rs = phase_engine(card)
    launches["engine_keep_all"], keep_storage, keep_rs = phase_keep_all(card)
    with tempfile.TemporaryDirectory() as tmp:
        launches["cli"], inp, split1 = phase_cli(tmp)
        launches["ring"] = phase_ring(card, engine_storage, engine_rs)
        del engine_storage, engine_rs
        launches["rings_keep_all"] = phase_rings_keep_all(card, keep_storage, keep_rs)
        launches["cli_mesh"] = phase_cli_mesh(tmp, inp, split1)
    launches["king"] = phase_king_popcount(card)
    check(king_cuda.popc_launches == popc_launches,
          "the AND + popcount yardstick launched on the main path")
    say(json.dumps({"kernels": [{
        "name": "king_counts",
        "route": "cuda",
        "source": "cuking_tpu_torch/csrc/king_counts.cu",
        "replaces": "cuking_tpu/ops/king_pallas.py:359",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        **record,
    }]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
