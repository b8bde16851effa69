"""The one generator of the benchmark's inputs, driven by a traffic file.

Genotypes are drawn on the device from the seed with a ``torch.Generator``,
in blocks of :data:`CHUNK_ROWS` rows, so a seed gives the same genotypes on
any caller.  Each site has an alternate-allele frequency p, uniform in the
traffic's ``allele_freq`` range; a sample's genotype there is missing with
the traffic's ``missing_rate``, else 0, 1 or 2 alternate alleles in
Hardy-Weinberg proportions, (1 - p)^2, 2p(1 - p) and p^2.  So every sample
is unrelated to every other, and an unrelated pair's kin centres just below
0 with a spread that narrows as sites are added.

Families are the related pairs.  The traffic lists them as
``{"size", "degree", "count"}``: ``count`` families of ``size`` samples,
the first the source, each other member a copy of the source at a share
2^-degree of the sites (drawn from the seed, member by member) and its own
genotypes elsewhere: degree 0 is a clone (kin exactly 0.5), degree d a
relative of kin ~2^-(d+1).  The shard's edges (its corners, its sections'
panel edges, a row of another block) are planted first
(``frozen/cli_at_scale.py``); the other members are drawn from the
traffic's ``family_pool``: the shard's samples or the whole cohort.

The port reads either planes (a sweep cell's input, :func:`pack`) or a
Hail export's Parquet (a task cell's, :func:`write_input`).
"""

from __future__ import annotations

import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from kingbench.frozen.cli_at_scale import family_rows, special_rows

CHUNK_ROWS = 256
MISSING = -1


def sub_seed(seed: int, salt: int) -> int:
    """A 63-bit seed for one stream of draws of ``seed``."""
    state = np.random.SeedSequence([seed % (1 << 64), salt]).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def _generator(seed: int, salt: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, salt))
    return gen


def draw_codes(seed: int, rows: int, sites: int, traffic: dict, device) -> torch.Tensor:
    """[rows, sites] int8 genotypes (0, 1, 2; -1 missing) on ``device``."""
    gen = _generator(seed, 0, device)
    lo, hi = traffic["allele_freq"]
    p = lo + (hi - lo) * torch.rand(sites, generator=gen, device=device)
    q0 = (1 - p) ** 2
    q1 = q0 + 2 * p * (1 - p)
    m = float(traffic["missing_rate"])
    out = torch.empty((rows, sites), dtype=torch.int8, device=device)
    for r0 in range(0, rows, CHUNK_ROWS):
        u = torch.rand((min(CHUNK_ROWS, rows - r0), sites), generator=gen, device=device)
        v = (u - m) / (1 - m)
        g = (v >= q0).to(torch.int8) + (v >= q1).to(torch.int8)
        out[r0:r0 + len(u)] = g.masked_fill_(u < m, MISSING)
    return out


def families(traffic: dict, shard, seed: int) -> list[tuple[np.ndarray, int]]:
    """(global rows, degree) of each family; the first row is the source."""
    spec = [(f["size"], f["degree"]) for f in traffic["families"] for _ in range(f["count"])]
    pool = (shard.sample_ids() if traffic["family_pool"] == "shard"
            else np.arange(shard.samples))
    rng = np.random.default_rng(sub_seed(seed, 2))
    rows = family_rows([s for s, _ in spec], special_rows(shard, shard.panel), pool, rng)
    return [(r, d) for r, (_, d) in zip(rows, spec)]


def plant(codes: torch.Tensor, fams, local: dict | None, seed: int) -> None:
    """Copies each family's source into its members, in place; ``local``
    maps a global row to a row of ``codes`` (None: the same)."""
    gen = _generator(seed, 1, codes.device)
    sites = codes.shape[1]
    for rows, degree in fams:
        idx = [local[r] for r in rows.tolist()] if local is not None else rows.tolist()
        src, members = idx[0], torch.tensor(idx[1:], device=codes.device)
        source = codes[src].clone().expand(len(members), sites)
        if degree == 0:
            codes[members] = source
            continue
        copied = torch.rand((len(members), sites), generator=gen, device=codes.device)
        codes[members] = torch.where(copied < 0.5 ** degree, source, codes[members])


def pack(codes: torch.Tensor, words: int) -> torch.Tensor:
    """[n, sites] int8 genotypes → the port's planes, [2, n, words] int32
    (plane 0 het, plane 1 hom-alt; a missing genotype sets both bits and
    hom-ref neither); site s in word s % words at bit s // words, and the
    sites past ``sites`` missing."""
    n, sites = codes.shape
    full = torch.full((n, 32 * words), MISSING, dtype=torch.int8, device=codes.device)
    full[:, :sites] = codes
    g = full.view(n, 32, words)
    weight = torch.tensor([1 << b for b in range(31)] + [-(1 << 31)], dtype=torch.int32,
                          device=codes.device).view(1, 32, 1)
    missing = g == MISSING
    out = torch.empty((2, n, words), dtype=torch.int32, device=codes.device)
    for plane, value in enumerate((1, 2)):
        bits = ((g == value) | missing).to(torch.int32)
        out[plane] = (bits * weight).sum(dim=1, dtype=torch.int32)
    return out


def sample_id(k: int) -> str:
    return f"S{k:07d}"


def _write_file(codes: np.ndarray, lo: int, hi: int, path: str) -> tuple[int, int]:
    """Sites [lo, hi) of ``codes`` ([samples, sites] int8) as a Hail export
    writes them: site by site, samples ascending, missing cells omitted,
    ``row_idx INT64, col_idx INT64, n_alt_alleles INT32``, ZSTD."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    samples = codes.shape[0]
    g = np.ascontiguousarray(codes[:, lo:hi].T).ravel()
    idx = np.flatnonzero(g >= 0)
    table = pa.table({"row_idx": pa.array(lo + idx // samples, pa.int64()),
                      "col_idx": pa.array(idx % samples, pa.int64()),
                      "n_alt_alleles": pa.array(g[idx].astype(np.int32), pa.int32())})
    pq.write_table(table, path, compression="zstd")
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)  # written back now, in set-up, and not under the window's tasks
    finally:
        os.close(fd)
    return len(idx), os.path.getsize(path)


def write_input(codes: np.ndarray, num_sites: int, input_dir: str, sites_per_file: int,
                threads: int) -> dict:
    """The input directory: a Parquet file of every ``sites_per_file``
    sites of ``codes`` and ``metadata.json`` (``num_sites`` sites, one ID per
    row of ``codes``); its entries, bytes, files and seconds."""
    # Imported on the calling thread: a first import of pyarrow inside a
    # pool's worker has been seen to leave a later read on this thread to
    # crash.
    import pyarrow.parquet  # noqa: F401

    t = time.perf_counter()
    os.makedirs(input_dir, exist_ok=True)
    written = codes.shape[1]
    spans = [(lo, min(lo + sites_per_file, written)) for lo in range(0, written, sites_per_file)]
    with ThreadPoolExecutor(max_workers=threads) as pool:
        done = list(pool.map(
            lambda k: _write_file(codes, *spans[k],
                                  os.path.join(input_dir, f"part-{k:05d}-c000.zstd.parquet")),
            range(len(spans))))
    with open(os.path.join(input_dir, "metadata.json"), "w") as f:
        json.dump({"num_sites": num_sites,
                   "samples": [sample_id(k) for k in range(codes.shape[0])]}, f)
    return {"entries": sum(d[0] for d in done), "bytes": sum(d[1] for d in done),
            "files": len(spans), "seconds": time.perf_counter() - t}
