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
5. The CLI end to end on a synthetic Parquet input (needs pyarrow): split 1,
   the three shards of split 2 merged, and the CPU plain path, all equal.

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Stage logs go to stderr.
"""

from __future__ import annotations

import json
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


def phase_engine(card: str) -> int:
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
    return launches


def phase_keep_all(card: str) -> None:
    import torch

    from cuking_tpu_torch.models.king import KingConfig, KingEngine, PanelStorage
    from cuking_tpu_torch.ops.bitset import PlaneLayout
    from cuking_tpu_torch.parallel.submatrix import Submatrix

    n = 4096
    rng = np.random.default_rng(SEED + 2)
    layout = PlaneLayout.create(SITES)
    storage = PanelStorage(layout, Submatrix.create(n, 1, 0), 1024)
    fill_random_planes(storage.planes, layout, rng)
    results, times = {}, {}
    for kernel in ("cuda", "matmul"):
        engine = KingEngine(storage, KingConfig(kernel=kernel, device="cuda",
                                                kin_threshold=-2.0))
        engine.planes_dev
        torch.cuda.synchronize()
        t = time.perf_counter()
        results[kernel] = engine.run()
        times[kernel] = time.perf_counter() - t
    a, b = results["cuda"], results["matmul"]
    check(len(a) == n * (n - 1) // 2, f"keep-all gave {len(a)} hits")
    for f in ("i_idx", "j_idx", "ibs0", "ibs1", "ibs2"):
        check(np.array_equal(getattr(a, f), getattr(b, f)), f"keep-all {f} differs")
    check(np.array_equal(a.kin.view(np.uint32), b.kin.view(np.uint32)),
          "keep-all kin bits differ")
    say(f"phase 4: keep-all {n} x {SITES}: {len(a)} hits, cuda and matmul engines "
        f"identical (sweep incl. sort: cuda {times['cuda']:.3f} s, matmul "
        f"{times['matmul']:.3f} s, {card})")


def _rows(output_uri: str) -> list:
    from cuking_tpu_torch.io.uri import Storage
    from cuking_tpu_torch.io.writer import read_results_table

    t = read_results_table(Storage(), output_uri)
    kin_bits = np.asarray(t.column("kin").to_numpy(), np.float32).view(np.uint32)
    cols = [t.column(c).to_pylist() for c in ("i", "j", "ibs0", "ibs1", "ibs2")]
    return sorted(zip(cols[0], cols[1], kin_bits.tolist(), *cols[2:]))


def phase_cli() -> None:
    try:
        import pyarrow  # noqa: F401
    except ImportError:
        say("phase 5: skipped: pyarrow is not installed, so the Parquet "
            "round trip through the CLI cannot run here")
        return
    from cuking_tpu_torch import cli
    from cuking_tpu_torch.io.synthetic_input import write_synthetic_input
    from cuking_tpu_torch.io.uri import Storage
    from cuking_tpu_torch.ops import king_cuda
    from cuking_tpu_torch.utils.synthetic import random_genotypes

    g = random_genotypes(1000, 10_000, missing_rate=0.05, seed=SEED,
                         num_related_pairs=5)
    with tempfile.TemporaryDirectory() as tmp:
        inp = f"{tmp}/in.parquet"
        write_synthetic_input(Storage(), inp, g)

        def run(out, *extra):
            rc = cli.main(["--input_uri", inp, "--output_uri", out, "--quiet", *extra])
            check(rc == 0, f"cli {' '.join(extra)} exited {rc}")

        king_cuda.launches = 0
        run(f"{tmp}/split1", "--device", "cuda")
        for shard in range(3):
            run(f"{tmp}/split2", "--device", "cuda", "--split_factor", "2",
                "--shard_index", str(shard))
        launches = king_cuda.launches
        run(f"{tmp}/cpu", "--device", "cpu", "--kernel", "matmul")
        split1, split2, cpu = (_rows(f"{tmp}/{d}") for d in ("split1", "split2", "cpu"))
    check(len(split1) >= 5, f"CLI found {len(split1)} related pairs, expected >= 5")
    check(split2 == split1, "merged split-2 shards differ from the split-1 run")
    check(cpu == split1, "the cuda run differs from the CPU plain-path run")
    check(launches > 0, "the CLI launched no count kernel")
    say(f"phase 5: CLI 1000 x 10000: {len(split1)} rows; split 2 merged == split 1 "
        f"== --device cpu --kernel matmul, bit for bit; {launches} kernel launches")


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
    launches = phase_engine(card)
    phase_keep_all(card)
    phase_cli()
    say(json.dumps({"kernels": [{
        "name": "king_counts",
        "route": "cuda",
        "source": "cuking_tpu_torch/csrc/king_counts.cu",
        "replaces": "cuking_tpu/ops/king_pallas.py:359",
        "launches": launches,
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
