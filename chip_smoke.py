#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port (``cuking_tpu_torch``) once on one NVIDIA GPU.

Run from the repository root with one CUDA device::

    python3 chip_smoke.py

Phases (any failure exits nonzero):

0. Environment: torch/CUDA versions, ``nvcc --version``, the card's name and
   power limit.
1. Build the CUDA count kernel from ``cuking_tpu_torch/csrc`` (nvcc).
2. Kernel vs its plain PyTorch version on the card, at 100,000 sites: the
   indexed entry (offsets into a 4,096-row storage, separate ``planes_j``),
   an asymmetric ``panel_j``, a ``tri`` diagonal pair, a small ragged W with
   partial tiles, and the sliced entry.  All six counters must be equal; 64
   sampled pairs are also held against the numpy oracle.  Times the kernel
   and the plain version at the engine's shape (1024 x 1024 pairs).
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
just after.  The second-to-last line is the kernels' JSON record; the last
line is ``{"ok": true, "device": {...}}``.  Stage logs go to stderr.
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


def padding_mask(layout) -> np.ndarray:
    """[W] uint32: the bits of each word that hold padding sites (site
    s = b·W + w ≥ num_sites), which must read as missing."""
    w = np.arange(layout.words, dtype=np.int64)
    mask = np.zeros(layout.words, dtype=np.uint32)
    for b in range(32):
        mask |= np.where(b * layout.words + w >= layout.num_sites,
                         np.uint32(1 << b), np.uint32(0))
    return mask


def fill_random_planes(planes: np.ndarray, layout, rng, block: int = 4096) -> None:
    """Uniform random het/hom bits (so 1/4 of the sites are missing), padding
    sites set missing; written in row blocks to bound host memory."""
    pad = padding_mask(layout)
    for lo in range(0, planes.shape[1], block):
        hi = min(lo + block, planes.shape[1])
        planes[:, lo:hi] = rng.integers(
            0, 1 << 32, size=(2, hi - lo, layout.words), dtype=np.uint32) | pad


def random_planes(rows: int, layout, rng) -> np.ndarray:
    planes = np.empty((2, rows, layout.words), dtype=np.uint32)
    fill_random_planes(planes, layout, rng)
    return planes


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
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            say(f"  ptxas: {line.strip()}")


def phase_kernel(card: str) -> dict:
    import torch

    from cuking_tpu_torch.ops.bitset import PlaneLayout, planes_to_genotypes
    from cuking_tpu_torch.ops.king_cuda import (
        panel_counts_cuda,
        panel_counts_cuda_indexed,
    )
    from cuking_tpu_torch.ops.king_mm import panel_counts_matmul
    from cuking_tpu_torch.ops.oracle import oracle_counts

    rng = np.random.default_rng(SEED)
    dev = torch.device("cuda", 0)
    layout = PlaneLayout.create(SITES)
    store_np = random_planes(4096, layout, rng)
    pj_np = random_planes(2048, layout, rng)
    store = torch.from_numpy(store_np.view(np.int32)).to(dev)
    pj = torch.from_numpy(pj_np.view(np.int32)).to(dev)
    small_layout = PlaneLayout.create(3_100)  # W = 100: ragged 16-word chunk
    small = torch.from_numpy(random_planes(1800, small_layout, rng).view(np.int32)).to(dev)

    def plain(a, i_off, ni, b, j_off, nj):
        return panel_counts_matmul(a[:, i_off:i_off + ni], b[:, j_off:j_off + nj])

    cases = [
        # name, kernel call, plain call, compare upper triangle only
        ("indexed 1024x1024, i_off=1000 into 4096 rows, separate planes_j j_off=300",
         lambda: panel_counts_cuda_indexed(store, 1000, 300, 0, 1024, planes_j=pj),
         lambda: plain(store, 1000, 1024, pj, 300, 1024), False),
        ("indexed asymmetric panel_j=640, i_off=2048, j_off=1537",
         lambda: panel_counts_cuda_indexed(store, 2048, 1537, 0, 1024, panel_j=640),
         lambda: plain(store, 2048, 1024, store, 1537, 640), False),
        ("indexed tri=1 diagonal pair at 1024 (i<j compared)",
         lambda: panel_counts_cuda_indexed(store, 1024, 1024, 1, 1024),
         lambda: plain(store, 1024, 1024, store, 1024, 1024), True),
        ("indexed ragged W=100 (3,100 sites), 1000x700 partial tiles",
         lambda: panel_counts_cuda_indexed(small, 17, 1100, 0, 1000, panel_j=700),
         lambda: plain(small, 17, 1000, small, 1100, 700), False),
        ("sliced entry 1024x1024",
         lambda: panel_counts_cuda(store[:, :1024].contiguous(),
                                   pj[:, 1024:2048].contiguous()),
         lambda: plain(store, 0, 1024, pj, 1024, 1024), False),
    ]
    max_err = 0
    first = None
    for name, kern, ref, upper in cases:
        got, exp = kern(), ref()
        torch.cuda.synchronize()
        first = first or got
        for k, (g, e) in enumerate(zip(got, exp)):
            if upper:
                keep = torch.ones_like(g, dtype=torch.bool).triu(1)
                g, e = g[keep], e[keep]
            err = int((g.long() - e.long()).abs().max())
            max_err = max(max_err, err)
            check(err == 0, f"{name}: counter {got._fields[k]} differs by {err}")
        say(f"phase 2: {name}: six counters equal the plain version")

    # 64 sampled pairs of the first case against the numpy oracle.
    counts = [c.cpu().numpy() for c in first]
    ii = rng.integers(0, 1024, 64)
    jj = rng.integers(0, 1024, 64)
    gi = planes_to_genotypes(store_np[:, 1000 + ii], layout)
    gj = planes_to_genotypes(pj_np[:, 300 + jj], layout)
    for n in range(64):
        exp = oracle_counts(gi[n:n + 1], gj[n:n + 1])
        for k, e in enumerate(exp):
            check(int(counts[k][ii[n], jj[n]]) == int(e[0, 0]),
                  f"oracle pair {n}: counter {first._fields[k]}")
    say("phase 2: 64 sampled pairs equal the numpy oracle")

    # The engine's shape: an off-diagonal 1024 x 1024 panel pair at 100k sites.
    ms = cuda_ms(lambda: panel_counts_cuda_indexed(store, 0, 2048, 0, 1024),
                 iters=20, warmup=3)
    plain_ms = cuda_ms(lambda: plain(store, 0, 1024, store, 2048, 1024),
                       iters=5, warmup=1)
    say(f"phase 2: 1024x1024 pairs x {layout.words} words: kernel {ms:.3f} ms, "
        f"plain version {plain_ms:.3f} ms ({card})")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms}


def phase_engine(card: str):
    import torch

    from cuking_tpu_torch.models.king import KingConfig, KingEngine, PanelStorage
    from cuking_tpu_torch.ops import king_cuda
    from cuking_tpu_torch.ops.bitset import PlaneLayout
    from cuking_tpu_torch.parallel.submatrix import Submatrix
    from cuking_tpu_torch.utils.stopwatch import StageLogger

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
    return launches, storage, rs


def phase_keep_all(card: str):
    import torch

    from cuking_tpu_torch.models.king import KingConfig, KingEngine, PanelStorage
    from cuking_tpu_torch.ops import king_cuda
    from cuking_tpu_torch.ops.bitset import PlaneLayout
    from cuking_tpu_torch.parallel.submatrix import Submatrix

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
        from cuking_tpu_torch.ops import king_cuda  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import the port (run from the repository "
              f"root): {e}", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    card = phase_env()
    phase_build()
    record = phase_kernel(card)
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
