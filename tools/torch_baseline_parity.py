#!/usr/bin/env python3
"""BASELINE-scale parity of the PyTorch/CUDA port (``cuking_tpu_torch``)
against an independent numpy oracle, through the port's CLI on the card.

The twin of ``tools/baseline_parity.py``, which checks the JAX package.  At
the BASELINE config's 1,000 samples x 100,000 sites, with edge cases
grafted onto samples 0-7, three checks run ``cuking_tpu_torch.cli`` in this
process on one synthetic Parquet input, written once before them:

1. **Full matrix**: a catch-all threshold, so every finite-kin pair
   (495,510 at 1,000 samples) is emitted; each is compared with the oracle,
   kin as uint32 bits and ibs0/1/2 exactly.
2. **Thresholded**: the reference's default 0.0884 threshold against the
   oracle's subset.
3. **Sharded merge**: ``--split_factor 4``, ten shard runs whose merged
   partitions must equal the oracle's thresholded rows, row for row.

The oracle shares no code with either package: fp32 GEMMs over 0/1
indicator planes in numpy (every partial sum is an integer below 2^24, so
exact), then the published estimator with one IEEE fp32 rounding per
operation, anchored to a per-pair scalar count on sampled pairs.

    python3 tools/torch_baseline_parity.py               # on the card
    python3 tools/torch_baseline_parity.py --device cpu --samples 96 --sites 2000

Prints each stage's wall time, the card's name and power limit, and one
JSON line last.  Exits 1 on any difference, and 2 without a card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

CATCH_ALL = -1e30  # below any finite fp32 kin; NaN/-inf still excluded


class ParityError(RuntimeError):
    """The oracle disagrees with its scalar anchor, or a CLI run failed."""


def edge_case_genotypes(n, s, seed):
    """``random_genotypes`` cohort with edge cases grafted onto samples 0-7
    (the cohort of ``tools/baseline_parity.py:edge_case_genotypes``, made
    with the port's copy of the generator)."""
    from cuking_tpu_torch.utils.synthetic import random_genotypes

    g = random_genotypes(n, s, missing_rate=0.05, seed=seed, num_related_pairs=5)
    g[1] = g[0]                                   # identical pair: kin 0.5
    g[2] = g[0]
    g[2, ::7] = -1                                # identical modulo missing
    g[3] = np.where(g[0] < 0, -1,
                    np.where(g[0] == 1, 1, 2 - g[0]))  # opposing-hom heavy
    g[4] = -1                                     # fully missing sample
    g[5] = np.where(g[5] == 1, 0, g[5])           # zero hets: min_hets=0
    g[6] = 0                                      # all hom-ref
    g[7] = 2                                      # all hom-alt
    return g


# The oracle: copies of tools/baseline_parity.py's numpy-only
# oracle_counts_gemm, king_fp32, scalar_spot_check, expected_table and
# read_output_rows (the port imports nothing of the JAX package's files).


def oracle_counts_gemm(g, chunk_sites=20_000):
    """Six [N, N] int64 counters via fp32 GEMM over indicator planes.

    Per site-chunk every Gram partial sum is an integer <= chunk_sites
    < 2^24, so float32 accumulation is exact; chunks then accumulate in
    int64.  Plane order: R(=0), H(=1), A(=2), D(defined)."""
    n, s = g.shape
    gram = np.zeros((4 * n, 4 * n), np.int64)
    for lo in range(0, s, chunk_sites):
        gc = g[:, lo:lo + chunk_sites]
        planes = np.concatenate(
            [
                (gc == 0).astype(np.float32),
                (gc == 1).astype(np.float32),
                (gc == 2).astype(np.float32),
                (gc >= 0).astype(np.float32),
            ],
            axis=0,
        )
        gram += (planes @ planes.T).astype(np.int64)
    blk = lambda p, q: gram[p * n:(p + 1) * n, q * n:(q + 1) * n]
    R, H, A, D = 0, 1, 2, 3
    return {
        "both_het": blk(H, H),
        "het_i": blk(H, D),
        "het_j": blk(D, H),
        "opposing_hom": blk(R, A) + blk(A, R),
        "concordant_hom": blk(R, R) + blk(A, A),
        "shared_sites": blk(D, D),
    }


def king_fp32(c):
    """Counts -> (kin, ibs0/1/2) with one IEEE fp32 rounding per op — the
    published estimator exactly as the reference kernel computes it
    (cuking.cu:286-307)."""
    f = np.float32
    bh = c["both_het"].astype(f)
    hi = c["het_i"].astype(f)
    hj = c["het_j"].astype(f)
    oh = c["opposing_hom"].astype(f)
    min_hets = np.minimum(hi, hj)
    with np.errstate(divide="ignore", invalid="ignore"):
        numer = (f(2.0) * bh - f(4.0) * oh - hi) - hj
        kin = f(0.5) + numer / (f(4.0) * min_hets)
    ibs0 = c["opposing_hom"]
    ibs2 = c["concordant_hom"] + c["both_het"]
    ibs1 = c["shared_sites"] - ibs0 - ibs2
    return kin.astype(f), ibs0, ibs1, ibs2


def scalar_spot_check(g, counts, num_pairs, seed):
    """Anchor the GEMM oracle to a direct per-pair scalar count on a random
    pair subset + the grafted edge-case pairs."""
    rng = np.random.default_rng(seed)
    n = g.shape[0]
    pairs = {(0, 1), (0, 2), (0, 3), (0, 4), (5, 6), (6, 7)}
    num_pairs = min(num_pairs, n * (n - 1) // 2)  # else the draw loop spins
    while len(pairs) < num_pairs:
        i, j = rng.integers(0, n, 2)
        if i < j:
            pairs.add((int(i), int(j)))
    for i, j in sorted(pairs):
        gi, gj = g[i], g[j]
        defined = (gi >= 0) & (gj >= 0)
        het_i, het_j = (gi == 1) & defined, (gj == 1) & defined
        expect = {
            "both_het": int(np.sum(het_i & het_j)),
            "het_i": int(np.sum(het_i)),
            "het_j": int(np.sum(het_j)),
            "opposing_hom": int(np.sum((((gi == 0) & (gj == 2))
                                        | ((gi == 2) & (gj == 0))) & defined)),
            "concordant_hom": int(np.sum((((gi == 0) & (gj == 0))
                                          | ((gi == 2) & (gj == 2))) & defined)),
            "shared_sites": int(np.sum(defined)),
        }
        for k, v in expect.items():
            got = int(counts[k][i, j])
            if got != v:
                raise ParityError(
                    f"GEMM oracle disagrees with scalar count: pair ({i},{j})"
                    f" {k}: gemm={got} scalar={v}"
                )
    return len(pairs)


def expected_table(g, threshold):
    """Oracle (i, j, kin_bits, ibs0/1/2) rows for all i<j with finite kin
    strictly above threshold, sorted by (i, j)."""
    n = g.shape[0]
    counts = oracle_counts_gemm(g)
    npairs = scalar_spot_check(g, counts, num_pairs=40, seed=7)
    kin, ibs0, ibs1, ibs2 = king_fp32(counts)
    iu, ju = np.triu_indices(n, k=1)
    k = kin[iu, ju]
    keep = np.isfinite(k) & (k > np.float32(threshold))
    rows = np.rec.fromarrays(
        [
            iu[keep].astype(np.int64),
            ju[keep].astype(np.int64),
            k[keep].view(np.uint32),
            ibs0[iu, ju][keep],
            ibs1[iu, ju][keep],
            ibs2[iu, ju][keep],
        ],
        names="i,j,kin_bits,ibs0,ibs1,ibs2",
    )
    nonfinite = int(np.sum(~np.isfinite(k)))
    return rows, nonfinite, npairs


def read_output_rows(out_dir, sample_ids):
    """CLI output partitions -> the same record layout as expected_table."""
    import pyarrow.parquet as pq

    idx = {s: k for k, s in enumerate(sample_ids)}
    parts = sorted(
        f for f in os.listdir(out_dir) if f.endswith(".parquet")
    )
    cols = {k: [] for k in ("i", "j", "kin", "ibs0", "ibs1", "ibs2")}
    for p in parts:
        t = pq.read_table(os.path.join(out_dir, p))
        for k in cols:
            cols[k].append(t[k].to_numpy(zero_copy_only=False))
    cat = {k: np.concatenate(v) if v else np.array([]) for k, v in cols.items()}
    i = np.array([idx[s] for s in cat["i"]], np.int64)
    j = np.array([idx[s] for s in cat["j"]], np.int64)
    rows = np.rec.fromarrays(
        [
            i,
            j,
            cat["kin"].astype(np.float32).view(np.uint32),
            cat["ibs0"].astype(np.int64),
            cat["ibs1"].astype(np.int64),
            cat["ibs2"].astype(np.int64),
        ],
        names="i,j,kin_bits,ibs0,ibs1,ibs2",
    )
    order = np.lexsort((rows.j, rows.i))
    return rows[order], len(parts)


def compare(tag, got, want, log) -> int:
    """The rows of ``want`` that ``got`` does not hold field for field
    (every row when the row counts differ); logs the first difference."""
    if len(got) != len(want):
        log(f"{tag}: {len(got)} rows from the pipeline, {len(want)} from the oracle")
        return max(len(got), len(want))
    bad = np.zeros(len(want), bool)
    for field in want.dtype.names:
        bad |= got[field] != want[field]
    n = int(bad.sum())
    if n:
        k = int(np.nonzero(bad)[0][0])
        log(f"{tag}: {n} rows differ; the first at row {k}: pipeline={got[k]} "
            f"oracle={want[k]}")
    else:
        log(f"{tag}: {len(want)} rows bit-identical")
    return n


def run_parity(samples: int = 1000, sites: int = 100_000, *, device: str = "cuda",
               threshold: float = 0.0884, split_factor: int = 4, seed: int = 42,
               workdir: str | None = None, log=print) -> dict:
    """Runs the three checks and returns the result record, whose
    ``differences`` counts the rows that differ in each (``ok`` when all are
    0).  Raises ParityError when the oracle or a CLI run fails.  ``log``
    takes one line per stage and check."""
    from cuking_tpu_torch import cli
    from cuking_tpu_torch.io.synthetic_input import write_synthetic_input
    from cuking_tpu_torch.io.uri import Storage
    from cuking_tpu_torch.parallel.submatrix import num_shards

    if samples < 9:
        raise ValueError("samples must be >= 9 (samples 0-7 carry grafted edge "
                         "cases; at least one regular sample is needed)")
    stages: dict = {}

    def stage(name, fn):
        t = time.perf_counter()
        out = fn()
        stages[name] = time.perf_counter() - t
        log(f"{name}: {stages[name]:.3f} s")
        return out

    def run_cli(*argv):
        rc = cli.main(["--input_uri", in_dir, "--device", device, "--quiet", *argv])
        if rc != 0:
            raise ParityError(f"the CLI exited {rc}: {' '.join(argv)}")

    wd = workdir or tempfile.mkdtemp(prefix="torch_baseline_parity_")
    shutil.rmtree(wd, ignore_errors=True)
    os.makedirs(wd)
    try:
        in_dir = os.path.join(wd, "in.parquet")
        g = edge_case_genotypes(samples, sites, seed)
        meta = stage("write", lambda: write_synthetic_input(
            Storage(), in_dir, g, num_partitions=8))
        want_all, nonfinite, spot = stage("oracle", lambda: expected_table(g, CATCH_ALL))
        del g
        want_thr = want_all[want_all.kin_bits.view(np.float32) > np.float32(threshold)]

        out_full = os.path.join(wd, "out_full.parquet")
        stage("cli_full", lambda: run_cli(
            "--output_uri", out_full, f"--kin_threshold={CATCH_ALL}",
            "--max_results", str(samples * samples)))
        got_full, _ = read_output_rows(out_full, meta.samples)
        diffs = {"full": compare(
            f"full matrix ({nonfinite} nonfinite pairs excluded, oracle spot-checked "
            f"on {spot} pairs)", got_full, want_all, log)}

        out_thr = os.path.join(wd, "out_thr.parquet")
        stage("cli_threshold", lambda: run_cli(
            "--output_uri", out_thr, "--kin_threshold", str(threshold)))
        got_thr, _ = read_output_rows(out_thr, meta.samples)
        diffs["thresholded"] = compare(f"thresholded (> {threshold})", got_thr,
                                       want_thr, log)

        shards = num_shards(split_factor)
        out_sh = os.path.join(wd, "out_sharded.parquet")
        for shard in range(shards):
            stage(f"cli_shard_{shard}", lambda: run_cli(
                "--output_uri", out_sh, "--kin_threshold", str(threshold),
                "--split_factor", str(split_factor), "--shard_index", str(shard)))
        got_sh, nparts = read_output_rows(out_sh, meta.samples)
        if nparts != shards:
            raise ParityError(f"expected {shards} partitions, found {nparts}")
        diffs["split_merge"] = compare(f"split {split_factor} merged ({shards} "
                                       "partitions)", got_sh, want_thr, log)
    finally:
        if workdir is None:
            shutil.rmtree(wd, ignore_errors=True)
    return {
        "samples": samples, "sites": sites, "device": device,
        "pairs_compared_bit_exact": int(len(want_all)),
        "nonfinite_pairs_excluded": nonfinite,
        "thresholded_pairs": int(len(want_thr)),
        "shards": shards,
        "differences": diffs,
        "stage_s": stages,
        "ok": not any(diffs.values()),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--samples", type=int, default=1000)
    ap.add_argument("--sites", type=int, default=100_000)
    ap.add_argument("--threshold", type=float, default=0.0884)
    ap.add_argument("--split-factor", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="the CLI's --device (default cuda; cpu runs the plain path)")
    ap.add_argument("--workdir", default=None,
                    help="keep the input and outputs here (default: a temporary "
                         "directory, removed afterwards)")
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)

    import torch

    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            print("torch_baseline_parity: no CUDA device; pass --device cpu to run "
                  "the plain path", file=sys.stderr)
            return 2
        from cuking_tpu_torch.utils.card import card_name

        card = card_name()
        print(f"card: {card}", file=sys.stderr)
    else:
        card = None
    try:
        result = run_parity(
            args.samples, args.sites, device=args.device, threshold=args.threshold,
            split_factor=args.split_factor, seed=args.seed, workdir=args.workdir,
            log=lambda line: print(f"  {line}", file=sys.stderr))
    except ParityError as e:
        print(f"torch_baseline_parity: {e}", file=sys.stderr)
        return 1
    result["card"] = card
    print(json.dumps(result))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    raise SystemExit(main())
