#!/usr/bin/env python3
"""One whole CLI task from Parquet at a deployment's size on one card, and
its ingest stage alone.

    python3 tools/torch_cli_at_scale.py                              # cell O
    python3 tools/torch_cli_at_scale.py --samples 730947 --files 1047 --split-factor 5 \\
        --shard-index 4 --ingest-runs 0 --ab-runs 0                  # cell R
    python3 tools/torch_cli_at_scale.py --samples 16384 --files 16 --ingest-runs 0 \\
        --ab-runs 0                                                  # chip_smoke.py phase 14
    python3 tools/torch_cli_at_scale.py --device cpu --samples 600 --sites 4000 \\
        --files 6 --sites-per-file 667 --ingest-runs 1 --ab-runs 1

The cohort (cell O) is 150,000 samples x 1,000,000 sites, one split-1 task
at ``--kin_threshold 0.0884`` with the CLI's defaults.  Its input is
written as a Hail export writes it (``interop/mt_to_inputs.py``):
site-ordered ZSTD Parquet, ``row_idx INT64, col_idx INT64, n_alt_alleles
INT32``, each file a run of consecutive sites over every sample in
ascending order, sized to 63 sites x 150,000 samples (~9M entries at 5%
missing, the file size ``cloud/batch_submit.py`` assumes).  Only the first
``--files`` files are written (216: sites 0-13,607, ~1.94e9 entries); the
other sites have no entries and read as missing, while ``metadata.json``
keeps every site and sample, so the planes, the sweep and its steps are the
whole task's.

Genotypes are random access: sample r's genotype at site s comes from
splitmix64 of (seed, source row, s), so any row is regenerated without
reading the files.  Each site has its own allele frequency p in [0.1, 0.5]
from the seed, and both alleles are drawn from it independently: every
sample is unrelated to every other, so an unrelated pair's kin centres on
~0 with a spread that narrows as more sites are written, and common
alleles keep the hets, kin's denominator, plentiful.  That no unrelated
pair reaches 0.0884 is checked, not assumed: the output must be exactly
the planted pairs (at cell O's 13,608 sites and phase 14's 9,232 it was,
over all of their pairs).  Planted
families are the related pairs: one source row and its members, clones
(the source's genotypes at every site, so kin == float32(0.5), ibs0 ==
ibs1 == 0 and ibs2 the source's defined sites) or, in some families,
half-copies (the source's genotypes on a half of the sites chosen by the
family's seed, their own elsewhere: kin ~0.25, counters that differ from
pair to pair).  Rows 0 and N - 1 are a clone pair, and rows 1,023 / 1,024
and 2,047 / 2,048 (panel edges) sit in a half-copy family.

``--split-factor k --shard-index s`` makes the task one shard of a split
cohort (cell R: 730,947 x 1,000,000, split 5, shard 4 = blocks (0, 4), its
i-range stored before its j-range, each padded to a panel multiple).  The
families then follow the shard: the shard's first i-row and last j-row are
the clone pair, and a half-copy family holds the block edges, the panel
edges of both sections (storage rows 1,023 / 1,024 of each), the j
section's first and last panels and a row of another block; the other
members are drawn from the whole cohort as before.  So the planted pairs
fall inside the shard, inside either block and between each block and the
others, and the output must be exactly those inside the shard.  The planes
check samples rows of both sections at the storage rows that
``PanelStorage.storage_offsets`` gives (held to the layout's own arithmetic
as well) and the padding rows of both sections, the class tallies count
the shard's samples only, and the launches are the shard's steps.

The tool writes the input (timed, outside every other window), then:

1. runs ``python3 -m cuking_tpu_torch.cli``'s ``main`` in a child process
   pinned to 26 CPUs (``a3-highgpu-1g``'s vCPUs, or all the process may use
   when it has fewer), untraced: its wall time, every stage of its log, the
   plane upload (timed around the engine's ``planes_dev``), the kernels'
   launches read in that process, and its peak RSS beside the planes
   against ``batch_submit.py``'s ingest and process terms; then, in the
   same process, the planes of sampled rows (rows 0 and N - 1, every
   planted row, the panel edges, 256 random rows) against the same
   genotypes packed by ``ops/bitset.pack_genotypes`` over every word, and
   the hom-ref / het / hom-alt bits of the whole shard against the
   classes the writer tallied;
2. runs ``ingest_parquet`` alone in fresh child processes into a fresh
   ``PanelStorage``: first an A/B in turns on all CPUs over the first 48
   files, of threads started inside every packer call (the
   packer's default) against one thread a call, and of Arrow's own pool in
   every ``pq.read_table`` (its default) against a serial decode (both
   forced by wrapping, see :data:`SETTINGS`); then ``--ingest-runs`` runs
   over every file as the package has it, on all CPUs and on the task's
   (when they are fewer), as many over the A/B's files on half the CPUs,
   and one split-2 shard-0 run whose filter drops half the entries; each with its entries/s, the decoders, readers and
   packer threads it used, and the read / decode / filter / scatter
   seconds summed over the workers (measured by wrapping those functions
   here);
3. holds the CLI's output rows to the planted pairs exactly: clones
   against their closed form, half-copies against the numpy oracle
   (``ops/oracle.oracle_king``) on the regenerated genotypes.

Prints the card's name and power limit, torch, the CPU model and count,
each stage (allocation, ingest with its entries read and kept, upload,
sweep and its ms a step), the launches, the peak device memory against
``check_engine_fit``'s model and the limit it read, and the peak host RSS
against ``cloud/batch_submit.py``'s terms, the card beside every number,
and one JSON line last.  Exits 1 when a check fails, 2 without a card
unless ``--device cpu``.  The input is deleted at exit.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import resource
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from functools import cached_property

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLES = 150_000
SITES = 1_000_000
FILES = 216
# Genotype cells per file: 63 sites x 150,000 samples, ~9.0M entries at 5%
# missing, the file size cloud/batch_submit.py's ingest term assumes.
CELLS_PER_FILE = 63 * 150_000
THRESHOLD = 0.0884
SEED = 20261017
TASK_CPUS = 26  # a3-highgpu-1g's vCPUs
PANEL = 1024
# Missing when the low 21 bits of a cell's hash fall below this: 5%, the
# cohort plan's ENTRY_DENSITY of 0.95.
MISSING_BELOW = round(0.05 * (1 << 21))
MASK21 = np.uint64((1 << 21) - 1)
# Family sizes of one cycle; the 16- and 96-member families are
# half-copies.  A cycle plants 329 rows and 18,538 pairs; cell O plants 5.
FAMILY_SIZES = (2, 16, 3, 4, 48, 96, 160)
HALF_COPY_SIZES = (16, 96)
# cloud/batch_submit.py's host-memory terms beside the planes, in MiB.
INGEST_TERM_MIB, PROCESS_TERM_MIB = 24_576, 8_192


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def rss_readings() -> dict:
    """This process's resident memory: ``VmRSS`` now, ``VmHWM`` (its own
    peak since its exec, where the kernel reports it) and ``ru_maxrss``,
    which in a child can also hold its parent's peak (on the H100 machine's
    host a child's ``ru_maxrss`` starts at the parent's)."""
    out = {"ru_maxrss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss << 10}
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(("VmRSS:", "VmHWM:")):
                out[f"{line.split(':')[0].lower()}_bytes"] = int(line.split()[1]) << 10
    return out


class PeakRss:
    """This process's own peak ``VmRSS``, sampled every ``interval`` seconds
    on a daemon thread (short spikes between samples are missed)."""

    def __init__(self, interval: float = 0.05):
        self.peak = 0
        self._interval = interval
        threading.Thread(target=self._run, daemon=True).start()

    def _run(self) -> None:
        while True:
            self.peak = max(self.peak, rss_readings().get("vmrss_bytes", 0))
            time.sleep(self._interval)

    def readings(self) -> dict:
        out = rss_readings()
        out["sampled_peak_bytes"] = max(self.peak, out.get("vmrss_bytes", 0))
        return out


def own_peak(readings: dict) -> tuple[int, str]:
    """(bytes, source) of a child's own peak RSS: ``VmHWM`` where the kernel
    reports it, else the sampled peak."""
    if "vmhwm_bytes" in readings:
        return readings["vmhwm_bytes"], "VmHWM"
    return readings["sampled_peak_bytes"], "VmRSS sampled every 50 ms"


def splitmix64(x: np.ndarray) -> np.ndarray:
    """splitmix64's finaliser of uint64 ``x`` (wrapping arithmetic)."""
    x = x + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


@dataclass(frozen=True)
class Cohort:
    """The seeded cohort: ``files`` files of ``sites_per_file`` consecutive
    sites each over all ``samples``; sites past them have no entries.  The
    task is shard ``shard_index`` of ``split_factor``."""

    samples: int = SAMPLES
    sites: int = SITES
    files: int = FILES
    sites_per_file: int = 63
    seed: int = SEED
    split_factor: int = 1
    shard_index: int = 0

    @cached_property
    def submatrix(self):
        from cuking_tpu_torch.parallel.submatrix import Submatrix

        return Submatrix.create(self.samples, self.split_factor, self.shard_index)

    @property
    def block_size(self) -> int:
        return -(-self.samples // self.split_factor)

    def special_rows(self) -> list[int]:
        """The rows planted first: the clone pair, then the half-copy
        family's edges.  At split 1 rows 0 / N - 1 and the panel edges
        1,023 / 1,024 and 2,047 / 2,048.  For a shard: its first i-row and
        last j-row; then its second i-row, the i section's panel edges and
        last row, a row of another block, and the j section's first two
        rows, panel edges and its last panel's first row and the row
        before it."""
        n = self.samples
        if self.split_factor == 1:
            rows = [0, n - 1, 1023, 1024, 2047, 2048]
        else:
            sm = self.submatrix
            j_last = sm.j_begin + (sm.num_cols - 1) // PANEL * PANEL
            other = (sm.i_end if sm.i_end < sm.j_begin
                     else sm.j_end if sm.j_end < n else sm.i_begin - 1)
            rows = [sm.i_begin, sm.j_end - 1,
                    sm.i_begin + 1, sm.i_begin + 1023, sm.i_begin + 1024, sm.i_end - 1, other,
                    sm.j_begin, sm.j_begin + 1, sm.j_begin + 1023, sm.j_begin + 1024,
                    j_last - 1, j_last]
        return [r for r in dict.fromkeys(rows) if 0 <= r < n]

    @property
    def written_sites(self) -> int:
        return min(self.sites, self.files * self.sites_per_file)

    def file_sites(self, f: int) -> np.ndarray:
        lo = f * self.sites_per_file
        return np.arange(lo, min(lo + self.sites_per_file, self.written_sites))

    def _key(self, salt: int) -> np.uint64:
        return splitmix64(np.array([self.seed * 4 + salt], np.uint64))[0]

    @cached_property
    def families(self) -> list[tuple[np.ndarray, bool]]:
        """(rows, half-copies?) per family; the first row is the source."""
        cycles = max(1, round(5 * self.samples / SAMPLES))
        sizes = list(FAMILY_SIZES) * cycles
        while sum(sizes) > self.samples // 4:  # plant at most a quarter
            sizes.remove(max(sizes))
        special = self.special_rows()
        rest = np.setdiff1d(np.arange(self.samples), special)
        order = np.random.default_rng(self.seed).permutation(rest)
        rows = np.concatenate([special, order[:sum(sizes) - len(special)]]).astype(np.int64)
        # Family 0 is the clone pair (0, N - 1, or the shard's corners);
        # family 1 (half-copies) holds the panel and block edges.
        out, k = [], 0
        for m in sizes:
            out.append((rows[k:k + m], m in HALF_COPY_SIZES))
            k += m
        return out

    @cached_property
    def _planted(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(source row, family, half-copy member?) per row; unplanted rows
        are their own source, of family -1."""
        source = np.arange(self.samples, dtype=np.int64)
        family = np.full(self.samples, -1, np.int64)
        half = np.zeros(self.samples, bool)
        for k, (rows, is_half) in enumerate(self.families):
            source[rows] = rows[0]
            family[rows] = k
            half[rows[1:]] = is_half
        return source, family, half

    @cached_property
    def _alt_below(self) -> np.ndarray:
        """Per written site: an allele is alt when its 21 hash bits fall
        below p x 2^21, p uniform in [0.1, 0.5] from the seed."""
        u = splitmix64(np.arange(self.written_sites, dtype=np.uint64) ^ self._key(1))
        p = 0.1 + 0.4 * (u >> np.uint64(40)).astype(np.float64) / float(1 << 24)
        return (p * (1 << 21)).astype(np.uint64)

    def _draw(self, src: np.ndarray, sites: np.ndarray) -> np.ndarray:
        """Genotypes (-1 missing) of source rows ``src`` at ``sites``,
        broadcast against each other."""
        key = (src.astype(np.uint64) << np.uint64(20)) | sites.astype(np.uint64)
        h = splitmix64(key ^ self._key(0))
        below = self._alt_below[sites]
        g = (((h >> np.uint64(21)) & MASK21) < below).astype(np.int8)
        g += (((h >> np.uint64(42)) & MASK21) < below).astype(np.int8)
        g[(h & MASK21) < np.uint64(MISSING_BELOW)] = -1
        return g

    def genotypes(self, rows, sites) -> np.ndarray:
        """[len(rows), len(sites)] int8 genotypes (0/1/2, -1 missing)."""
        rows = np.asarray(rows, np.int64)
        sites = np.asarray(sites, np.int64)
        g = np.full((len(rows), len(sites)), -1, np.int8)
        written = sites < self.written_sites
        if not written.any() or not len(rows):
            return g
        s = sites[written]
        source, family, half = self._planted
        src = np.repeat(source[rows][:, None], len(s), axis=1)
        hr = np.flatnonzero(half[rows])
        if len(hr):
            # A half-copy takes its source's genotype where its family's
            # hash bit is set, its own elsewhere.
            fam = family[rows[hr]].astype(np.uint64)
            copied = splitmix64(((fam[:, None] << np.uint64(20)) | s.astype(np.uint64))
                                ^ self._key(2)) & np.uint64(1)
            src[hr] = np.where(copied == 1, source[rows[hr]][:, None], rows[hr][:, None])
        g[:, written] = self._draw(src, s[None, :])
        return g


def cohort_for(samples: int = SAMPLES, sites: int = SITES, files: int = FILES,
               sites_per_file: int | None = None, seed: int = SEED,
               split_factor: int = 1, shard_index: int = 0) -> Cohort:
    """A cohort whose files hold ~``CELLS_PER_FILE`` cells each, unless
    ``sites_per_file`` is given."""
    spf = sites_per_file or max(1, round(CELLS_PER_FILE / samples))
    return Cohort(samples, sites, files, spf, seed, split_factor, shard_index)


# -- The input ------------------------------------------------------------


def file_entries(cohort: Cohort, f: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """File ``f``'s entries in a Hail export's order: site by site, samples
    ascending, missing cells omitted."""
    sites = cohort.file_sites(f)
    g = np.ascontiguousarray(cohort.genotypes(np.arange(cohort.samples), sites).T)
    idx = np.flatnonzero(g.ravel() >= 0)
    row_idx = sites[idx // cohort.samples].astype(np.int64)
    col_idx = (idx % cohort.samples).astype(np.int64)
    return row_idx, col_idx, g.ravel()[idx].astype(np.int32)


def tally(n_alt: np.ndarray) -> np.ndarray:
    """[hom-ref, het, hom-alt] counts."""
    return np.bincount(n_alt, minlength=3)[:3].astype(np.int64)


def write_file(cohort: Cohort, input_dir: str, f: int) -> tuple[int, np.ndarray, int, np.ndarray]:
    """Writes file ``f``; (entries, [hom-ref, het, hom-alt] tally, bytes,
    the tally of the shard's samples alone)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    row_idx, col_idx, n_alt = file_entries(cohort, f)
    table = pa.table({"row_idx": pa.array(row_idx, pa.int64()),
                      "col_idx": pa.array(col_idx, pa.int64()),
                      "n_alt_alleles": pa.array(n_alt, pa.int32())})
    path = os.path.join(input_dir, f"part-{f:05d}-c000.zstd.parquet")
    pq.write_table(table, path, compression="zstd")
    return (len(n_alt), tally(n_alt), os.path.getsize(path),
            tally(n_alt[cohort.submatrix.contains(col_idx)]))


def write_input(cohort: Cohort, input_dir: str, threads: int) -> dict:
    """The input directory (files and ``metadata.json``); entries, bytes,
    seconds, the class tallies of every file and those of the shard's
    samples (its entries: what the task's ingest keeps)."""
    # Imported here, on the calling thread: a first import of pyarrow inside
    # a pool's worker left a later pq.read_table on this thread to crash
    # with SIGSEGV (torch 2.13 for the CPU, pyarrow's own wheel).
    import pyarrow.parquet  # noqa: F401

    from cuking_tpu_torch.io.metadata import InputMetadata, write_metadata
    from cuking_tpu_torch.io.uri import Storage

    os.makedirs(input_dir, exist_ok=True)
    t = time.perf_counter()
    with ThreadPoolExecutor(max_workers=threads) as pool:
        done = list(pool.map(lambda f: write_file(cohort, input_dir, f), range(cohort.files)))
    write_metadata(Storage(), input_dir,
                   InputMetadata(num_sites=cohort.sites,
                                 samples=[f"S{k:06d}" for k in range(cohort.samples)]))
    return {"entries": sum(d[0] for d in done), "bytes": sum(d[2] for d in done),
            "write_s": time.perf_counter() - t,
            "file_tallies": [d[1].tolist() for d in done],
            "file_entries": [d[0] for d in done],
            "tallies": np.sum([d[1] for d in done], axis=0).tolist(),
            "shard_tallies": np.sum([d[3] for d in done], axis=0).tolist(),
            "shard_entries": int(sum(d[3].sum() for d in done))}


# -- Checks ---------------------------------------------------------------


def checked_rows(cohort: Cohort, extra_random: int = 256) -> np.ndarray:
    """The shard's samples among rows 0 and N - 1, the panel edges 1,023 /
    1,024, the special rows (:meth:`Cohort.special_rows`: both sections'
    edges), every planted row and ``extra_random`` seeded random rows of
    the shard."""
    n, sm = cohort.samples, cohort.submatrix
    planted = np.concatenate([rows for rows, _ in cohort.families])
    rng = np.random.default_rng(cohort.seed + 1)
    stored = sm.stored_sample_indices()
    rows = np.concatenate([[0, n - 1, 1023, 1024], cohort.special_rows(), planted,
                           stored[rng.integers(0, len(stored), extra_random)]])
    rows = np.unique(rows[rows < n])
    return rows[sm.contains(rows)]


def layout_rows(submatrix, panel: int, rows: np.ndarray) -> np.ndarray:
    """Storage rows of the shard's samples ``rows`` by the layout's own
    arithmetic (the i-range from row 0, the j-range after the i-range padded
    to a multiple of ``panel``), to hold ``storage_offsets`` to."""
    i_pad = -(-submatrix.num_rows // panel) * panel
    in_j = (rows >= submatrix.i_end) & ~submatrix.is_diagonal
    return np.where(in_j, i_pad + rows - submatrix.j_begin, rows - submatrix.i_begin)


def padding_rows(storage) -> np.ndarray:
    """Storage rows past each section's samples (the i section's, then the
    j section's off the diagonal)."""
    pad = np.arange(storage.nr, storage.nr_pad)
    if not storage.submatrix.is_diagonal:
        pad = np.concatenate([pad, storage.j_store_base + np.arange(storage.nc, storage.nc_pad)])
    return pad


def plane_mismatches(planes: np.ndarray, offsets: np.ndarray, cohort: Cohort,
                     rows: np.ndarray, threads: int = 4, chunk: int = 8) -> list[int]:
    """Rows whose stored planes (at storage rows ``offsets``) differ, in
    any word, from their regenerated genotypes packed by
    ``ops/bitset.pack_genotypes``, ``chunk`` rows at a time on ``threads``
    threads."""
    from cuking_tpu_torch.ops.bitset import PlaneLayout, pack_genotypes

    layout = PlaneLayout.create(cohort.sites)

    def differing(lo: int) -> list[int]:
        r = rows[lo:lo + chunk]
        want = pack_genotypes(cohort.genotypes(r, np.arange(cohort.sites)), layout)
        got = planes[:, offsets[lo:lo + chunk]]
        return r[(got != want).any(axis=(0, 2))].tolist()

    with ThreadPoolExecutor(max_workers=threads) as pool:
        return sum(pool.map(differing, range(0, len(rows), chunk)), [])


def plane_tallies(planes: np.ndarray, threads: int = 8, block: int = 1024) -> list[int]:
    """[hom-ref, het, hom-alt] bits over the whole of ``planes``
    ([2, rows, W]): (0, 0), (1, 0) and (0, 1) of (het, hom)."""

    def tally(lo: int) -> np.ndarray:
        het, hom = planes[0, lo:lo + block], planes[1, lo:lo + block]
        return np.array([np.bitwise_count(~het & ~hom).sum(dtype=np.int64),
                         np.bitwise_count(het & ~hom).sum(dtype=np.int64),
                         np.bitwise_count(~het & hom).sum(dtype=np.int64)])

    with ThreadPoolExecutor(max_workers=threads) as pool:
        parts = list(pool.map(tally, range(0, planes.shape[1], block)))
    return np.sum(parts, axis=0).tolist()


def expected_rows(cohort: Cohort, threshold: float = THRESHOLD) -> dict:
    """(i, j) → (kin bits, ibs0, ibs1, ibs2) of every planted pair, i < j:
    clones in closed form, half-copies by the numpy oracle.  Every pair must
    lie above ``threshold``, or the cohort is not the one described."""
    from cuking_tpu_torch.ops.oracle import oracle_king

    sites = np.arange(cohort.written_sites)
    half_bits = np.float32(0.5).view(np.uint32)
    want = {}
    for rows, is_half in cohort.families:
        g = cohort.genotypes(rows, sites)
        if not is_half:
            defined = int(np.count_nonzero(g[0] >= 0))
            for a in range(len(rows)):
                for b in range(a + 1, len(rows)):
                    i, j = sorted((int(rows[a]), int(rows[b])))
                    want[i, j] = (int(half_bits), 0, 0, defined)
            continue
        for lo in range(0, len(rows), 8):
            kin, ibs0, ibs1, ibs2 = oracle_king(g[lo:lo + 8], g)
            for a in range(lo, min(lo + 8, len(rows))):
                for b in range(a + 1, len(rows)):
                    i, j = sorted((int(rows[a]), int(rows[b])))
                    want[i, j] = (int(kin[a - lo, b].view(np.uint32)), int(ibs0[a - lo, b]),
                                  int(ibs1[a - lo, b]), int(ibs2[a - lo, b]))
    low = [k for k, v in want.items() if not np.uint32(v[0]).view(np.float32) > threshold]
    check(not low, f"{len(low)} planted pairs lie at or below {threshold}, e.g. {low[:3]}")
    return want


def shard_pairs(cohort: Cohort, want: dict) -> tuple[dict, dict]:
    """The planted pairs (``want``, i < j) that the shard computes (both in
    the shard, i in its i-range and j in its j-range), and the others
    counted by blocks: "blocks a-b" with a <= b."""
    sm, size = cohort.submatrix, cohort.block_size
    inside, outside = {}, {}
    for (i, j), v in want.items():
        if sm.i_begin <= i < sm.i_end and sm.j_begin <= j < sm.j_end:
            inside[i, j] = v
        else:
            kind = f"blocks {i // size}-{j // size}"
            outside[kind] = outside.get(kind, 0) + 1
    return inside, outside


def missing_kinds(cohort: Cohort, outside: dict) -> list[str]:
    """The kinds of planted pair outside the shard that a shard of a split
    cohort must have, so that its output shows it writes none of them: pairs
    inside each of its blocks, and between each of its blocks and another
    block; those of ``outside`` that are not there."""
    if cohort.split_factor == 1:
        return []
    size = cohort.block_size
    blocks = {cohort.submatrix.i_begin // size, cohort.submatrix.j_begin // size}
    counted = {tuple(map(int, k.split()[1].split("-"))): n for k, n in outside.items()}
    missing = []
    for b in sorted(blocks):
        if (b, b) not in counted and len(blocks) == 2:
            missing.append(f"inside block {b}")
        if not any(b in ab and not set(ab) <= blocks for ab in counted):
            missing.append(f"block {b} with a block outside the shard")
    return missing


def read_output(output_dir: str) -> dict:
    """The CLI's output partitions as (i, j) → (kin bits, ibs0, ibs1, ibs2),
    sample IDs mapped back to rows; a repeated pair fails."""
    import pyarrow.parquet as pq

    from cuking_tpu_torch.io.uri import Storage

    got = {}
    for path in Storage().list_parquet_files(output_dir):
        t = pq.read_table(path)
        i = [int(s[1:]) for s in t.column("i").to_pylist()]
        j = [int(s[1:]) for s in t.column("j").to_pylist()]
        kin = np.asarray(t.column("kin").to_numpy(), np.float32).view(np.uint32)
        ibs = [t.column(c).to_numpy() for c in ("ibs0", "ibs1", "ibs2")]
        for k in range(t.num_rows):
            check((i[k], j[k]) not in got, f"pair {(i[k], j[k])} written twice")
            got[i[k], j[k]] = (int(kin[k]), int(ibs[0][k]), int(ibs[1][k]), int(ibs[2][k]))
    return got


def row_differences(got: dict, want: dict) -> dict:
    """Missing, extra and differing pairs, counted, with a few of each."""
    missing = [k for k in want if k not in got]
    extra = [k for k in got if k not in want]
    wrong = [k for k in want if k in got and got[k] != want[k]]
    return {"missing": len(missing), "extra": len(extra), "wrong": len(wrong),
            "examples": [str(k) for k in (missing[:3] + extra[:3] + wrong[:3])]}


# -- Child processes ------------------------------------------------------

_CHILD = "from tools.torch_cli_at_scale import child; child()"
_STAGES = {
    "metadata": "Reading metadata",
    "allocate": "Allocating bit planes",
    "listing": "Listing input files",
    "ingest": "Processing Parquet tables",
    "king_kernel": "Running KING kernel for",
    "write": "Writing",
}


def stage_seconds(log: str) -> dict:
    """Each stage of the CLI's log, ``<message>...<dots> (<seconds>s)``."""
    out = {}
    for stage, message in _STAGES.items():
        m = re.search(re.escape(message) + r"[^\n]*?\.\.\.\.*\s*\(([0-9.]+)s\)", log)
        check(m is not None, f"no '{message}' stage in the task's log")
        out[stage] = float(m.group(1))
    return out


def run_child(spec: dict, timeout: float) -> tuple[dict, str, float]:
    """Runs :func:`child` on ``spec`` in a fresh process; (its JSON, its
    log, wall seconds)."""
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(spec)], cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t
    check(proc.returncode == 0, f"the {spec['mode']} child exited {proc.returncode}:\n"
                                f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    lines = proc.stdout.strip().splitlines()
    return json.loads(lines[-1]), "\n".join(lines[:-1]), wall


# What an ingest run may force, by wrapping functions here (the package has
# no switch for either): ``packer_threads`` is clear_bits' num_threads (0
# the packer's default, threads in every call of 65,536 entries or more; 1
# one thread a call), ``arrow_threads`` is pq.read_table's use_threads (on
# by default: Arrow's own CPU pool inside each decoder).  "package" forces
# nothing.
SETTINGS = {
    "package": {},
    "packer threads": {"packer_threads": 0},
    "packer 1 thread": {"packer_threads": 1},
    "arrow serial": {"arrow_threads": False},
    "packer 1 thread, arrow serial": {"packer_threads": 1, "arrow_threads": False},
}
# The A/B settings, run in turns: the package as the parent has it (threads
# in every packer call, Arrow's pool in every decode) against each change.
AB_SETTINGS = ("packer threads", "packer 1 thread", "arrow serial",
               "packer 1 thread, arrow serial")
AB_FILES = 48


# The port's ingest.* spans time the same phases, but record only under a
# profiler, whose cost this tool's A/B would then carry.
class IngestSplit:
    """Wraps, for one ingest, the functions of its stages (read, decode,
    filter, scatter) to sum their seconds over the workers, records the
    threads that ran them and the packer's threads per call, and applies
    a setting of :data:`SETTINGS`."""

    def __init__(self, storage, panel_storage, setting: dict):
        import pyarrow.parquet as pq

        from cuking_tpu_torch.io import parquet_ingest
        from cuking_tpu_torch.native import packer

        packer_threads = setting.get("packer_threads")
        if "arrow_threads" in setting:
            read_table = pq.read_table
            pq.read_table = lambda *a, **kw: read_table(
                *a, **dict(kw, use_threads=setting["arrow_threads"]))

        self.seconds = {"read": 0.0, "decode": 0.0, "filter": 0.0, "scatter": 0.0}
        self.threads = {"read": set(), "decode": set()}
        self.entries = self.kept = 0
        self.packer_calls = {}
        self._lock = threading.Lock()
        storage.read_bytes = self._timed("read", storage.read_bytes)
        panel_storage.contains = self._timed("filter", panel_storage.contains)
        panel_storage.storage_offsets = self._timed("filter", panel_storage.storage_offsets)
        decode = parquet_ingest._decode_file

        def decode_counted(buf, source):
            cols = decode(buf, source)
            with self._lock:
                self.entries += len(cols[0])
            return cols

        parquet_ingest._decode_file = self._timed("decode", decode_counted)
        clear_bits = packer.clear_bits

        def clear_bits_forced(*args, **kw):
            if packer_threads is not None:
                kw["num_threads"] = packer_threads
            n = len(args[4])
            threads = kw.get("num_threads", 0) or min(packer.usable_cpus(), 16)
            # native/packer.cpp starts threads only for 65,536 entries or more.
            started = threads if n >= 1 << 16 else 1
            with self._lock:
                self.kept += n
                self.packer_calls[started] = self.packer_calls.get(started, 0) + 1
            return clear_bits(*args, **kw)

        packer.clear_bits = self._timed("scatter", clear_bits_forced)

    def _timed(self, stage: str, fn):
        def wrapped(*args, **kw):
            t = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                dt = time.perf_counter() - t
                with self._lock:
                    self.seconds[stage] += dt
                    if stage in self.threads:
                        self.threads[stage].add(threading.get_ident())
        return wrapped


def child() -> None:
    """A child process: ``sys.argv[1]`` is a JSON spec.  It pins itself to
    ``cpus`` before importing anything else, then runs the CLI task
    (``mode`` "task") or one ingest (``mode`` "ingest") and prints one JSON
    line last."""
    spec = json.loads(sys.argv[1])
    os.sched_setaffinity(0, spec["cpus"])
    {"task": _task_child, "ingest": _ingest_child}[spec["mode"]](spec, PeakRss())


def _task_child(spec: dict, rss: PeakRss) -> None:
    import gc

    import torch

    from cuking_tpu_torch import cli
    from cuking_tpu_torch.models.king import KingEngine
    from cuking_tpu_torch.native import packer
    from cuking_tpu_torch.ops import king_cuda, king_emit
    from cuking_tpu_torch.utils.hbm import (
        device_bytes_limit,
        engine_plane_bytes,
        sweep_buffer_bytes,
    )
    from tools.torch_capacity_plan import shard_steps

    captured, upload, fit = {}, {}, {}
    ingest, check_fit = cli.ingest_parquet, cli.check_engine_fit

    def ingest_captured(storage, files, panel_storage, **kw):
        captured["storage"] = panel_storage
        captured["split"] = IngestSplit(storage, panel_storage, SETTINGS["package"])
        return ingest(storage, files, panel_storage, **kw)

    def check_fit_read(num_samples, words, submatrix, config, split_factor, **kw):
        # What the CLI's own check reads: the free memory, its limit and its
        # model of the shard's need.
        if cuda:
            fit["free_bytes"], fit["total_bytes"] = torch.cuda.mem_get_info(config.device)
        fit["limit_bytes"] = device_bytes_limit(config.device)
        fit["model_bytes"] = (engine_plane_bytes(submatrix, words, config.panel)
                              + sweep_buffer_bytes(config))
        return check_fit(num_samples, words, submatrix, config, split_factor, **kw)

    cli.ingest_parquet = ingest_captured
    cli.check_engine_fit = check_fit_read
    planes_dev = KingEngine.planes_dev.fget
    cuda = spec["device"].startswith("cuda")

    def planes_dev_timed(engine):
        if engine._planes_dev_cache is not None:
            return planes_dev(engine)
        captured["config"] = engine.config
        if cuda:
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            upload["base"] = torch.cuda.memory_allocated()
        t = time.perf_counter()
        out = planes_dev(engine)
        if cuda:
            torch.cuda.synchronize()
        upload["s"] = time.perf_counter() - t
        return out

    KingEngine.planes_dev = property(planes_dev_timed)
    king_cuda.launches = king_emit.emit_launches = 0
    t = time.perf_counter()
    rc = cli.main(spec["argv"])
    task_s = time.perf_counter() - t
    out = {"rc": rc, "task_s": task_s, "upload_s": upload.get("s"),
           "launches": {"king_counts": king_cuda.launches, "king_emit": king_emit.emit_launches},
           "peak_rss": rss.readings(), "usable_cpus": packer.usable_cpus(), "fit": fit}
    if cuda and "base" in upload:
        fit["peak_device_bytes"] = torch.cuda.max_memory_allocated() - upload["base"]
    if rc == 0:
        st, split = captured["storage"], captured["split"]
        cohort = Cohort(**spec["cohort"])
        rows = checked_rows(cohort)
        t = time.perf_counter()
        offsets = st.storage_offsets(rows)
        out["ingest_entries"], out["ingest_kept"] = split.entries, split.kept
        out["panel"] = st.panel
        out["steps"] = shard_steps(cohort.samples, cohort.split_factor,
                                   st.panel)[cohort.shard_index]
        out["planes_bytes"] = st.planes.nbytes
        out["stored_rows"] = st.planes.shape[1]
        out["rows_checked"] = len(rows)
        in_j = np.zeros(len(rows), bool) if st.submatrix.is_diagonal else offsets >= st.j_store_base
        out["sections_checked"] = [int((~in_j).sum()), int(in_j.sum())]
        out["offsets_differing"] = rows[offsets != layout_rows(st.submatrix, st.panel, rows)
                                        ].tolist()[:10]
        out["rows_differing"] = plane_mismatches(st.planes, offsets, cohort,
                                                 rows, threads=len(spec["cpus"]))
        pad = padding_rows(st)
        out["padding_rows"] = len(pad)
        out["padding_not_missing"] = pad[(st.planes[:, pad] != 0xFFFFFFFF).any(axis=(0, 2))
                                         ].tolist()[:10]
        out["plane_tallies"] = plane_tallies(st.planes, threads=len(spec["cpus"]))
        out["check_s"] = time.perf_counter() - t
    print(json.dumps(out), flush=True)


def _ingest_child(spec: dict, rss: PeakRss) -> None:
    from cuking_tpu_torch.io.metadata import read_metadata
    from cuking_tpu_torch.io.parquet_ingest import ingest_parquet
    from cuking_tpu_torch.io.uri import Storage
    from cuking_tpu_torch.models.king import PanelStorage
    from cuking_tpu_torch.native import packer
    from cuking_tpu_torch.ops.bitset import PlaneLayout
    from cuking_tpu_torch.parallel.submatrix import Submatrix

    storage = Storage()
    meta = read_metadata(storage, spec["input"])
    files = storage.list_parquet_files(spec["input"])
    check(packer.available(), "the native packer did not build")
    t = time.perf_counter()
    st = PanelStorage(PlaneLayout.create(meta.num_sites),
                      Submatrix.create(meta.num_samples, spec["split"], 0), PANEL)
    alloc_s = time.perf_counter() - t
    split = IngestSplit(storage, st, SETTINGS[spec["setting"]])
    t = time.perf_counter()
    ingest_parquet(storage, files[:spec["files"]], st)
    ingest_s = time.perf_counter() - t
    print(json.dumps({
        "cpus": len(spec["cpus"]), "usable_cpus": packer.usable_cpus(),
        "split_factor": spec["split"], "setting": spec["setting"], "files": spec["files"],
        "alloc_s": alloc_s, "ingest_s": ingest_s, "entries": split.entries,
        "kept": split.kept, "entries_per_s": split.entries / ingest_s,
        "decoders": len(split.threads["decode"]), "readers": len(split.threads["read"]),
        "packer_threads_per_call": split.packer_calls, "split_s": split.seconds,
        "peak_rss": rss.readings()}), flush=True)


# -- The run --------------------------------------------------------------


def cpu_model() -> str:
    with open("/proc/cpuinfo") as f:
        for line in f:
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    return "unknown"


def ingest_plan(files: int, runs: int, ab_runs: int, all_cpus: list,
                task_cpus: list) -> list[dict]:
    """The ingest runs: :data:`AB_SETTINGS` in turns (forwards, then
    backwards) on all CPUs over the first :data:`AB_FILES` files, ``ab_runs``
    of each; then the package ``runs`` times over every file on all CPUs
    and on the task's CPUs (when they are fewer), ``runs`` times over the
    first :data:`AB_FILES` files on half the CPUs (the rate and the memory
    against the decoder count), and once at split 2."""
    ab_files, plan = min(AB_FILES, files), []
    for k in range(ab_runs):
        order = AB_SETTINGS if k % 2 == 0 else AB_SETTINGS[::-1]
        plan += [{"cpus": all_cpus, "setting": s, "split": 1, "files": ab_files} for s in order]
    if not runs:
        return plan
    full = {"setting": "package", "split": 1, "files": files}
    plan += [dict(full, cpus=all_cpus) for _ in range(runs)]
    if len(task_cpus) < len(all_cpus):
        plan += [dict(full, cpus=task_cpus) for _ in range(runs)]
    half = all_cpus[:max(1, len(all_cpus) // 2)]
    plan += [dict(full, cpus=half, files=ab_files) for _ in range(runs)]
    return plan + [dict(full, cpus=all_cpus, split=2)]


def summarize(runs: list[dict]) -> dict:
    """entries/s (median, min, max) per (CPUs, setting, split, files)."""
    groups = {}
    for r in runs:
        groups.setdefault(f"{r['cpus']} cpus, {r['setting']}, split {r['split_factor']}, "
                          f"{r['files']} files", []).append(r["entries_per_s"])
    return {k: {"runs": len(v), "median": float(np.median(v)), "min": min(v), "max": max(v)}
            for k, v in groups.items()}


def run_cell(cohort: Cohort, workdir: str, *, device: str = "cuda", task_cpus: int = TASK_CPUS,
             ingest_runs: int = 3, ab_runs: int = 0, log=print) -> dict:
    """Writes the input under ``workdir``, runs the task and the ingest
    runs, and checks them; the result dict (``ok`` false on a failed
    check).  The input is deleted before it returns.  On a card every
    line logged ends with its name and power limit."""
    from cuking_tpu_torch.cloud.batch_submit import DEFAULT_MEMORY_MIB
    from cuking_tpu_torch.native import packer
    from tools.torch_shard_at_scale import settled_host_available_bytes

    all_cpus = sorted(os.sched_getaffinity(0))
    task = all_cpus[:task_cpus]
    check(packer.available(), "the native packer did not build")
    if device.startswith("cuda"):
        from cuking_tpu_torch.ops import king_cuda
        from cuking_tpu_torch.utils.card import card_name

        king_cuda.build()  # a task's image holds the library prebuilt
        card = card_name()
    else:
        card = f"--device {device}, no card"

    def say(line: str) -> None:
        log(f"{line} ({card})")

    input_dir = os.path.join(workdir, "input.parquet")
    output_dir = os.path.join(workdir, "output.parquet")
    sm = cohort.submatrix
    result = {"samples": cohort.samples, "sites": cohort.sites, "files": cohort.files,
              "sites_per_file": cohort.sites_per_file, "written_sites": cohort.written_sites,
              "split_factor": cohort.split_factor, "shard_index": cohort.shard_index,
              "submatrix": [sm.i_begin, sm.i_end, sm.j_begin, sm.j_end],
              "cpus": len(all_cpus), "task_cpus": len(task), "device": device, "card": card}
    try:
        w = write_input(cohort, input_dir, threads=len(all_cpus))
        result["input"] = {k: w[k] for k in ("entries", "bytes", "write_s", "tallies",
                                             "shard_entries", "shard_tallies")}
        say(f"wrote {cohort.files} files, {w['entries']:,} entries, {w['bytes']:,} B "
            f"({w['bytes'] / w['entries']:.2f} B per entry) in {w['write_s']:.1f} s "
            f"on {len(all_cpus)} threads; tallies hom-ref/het/hom-alt {w['tallies']}, "
            f"{w['shard_entries']:,} entries of the shard's samples")
        want, outside = shard_pairs(cohort, expected_rows(cohort))
        result["planted"] = {"in_shard": len(want), "outside_by_blocks": outside}
        say(f"shard {cohort.shard_index} of split {cohort.split_factor}: samples "
            f"[{sm.i_begin:,}, {sm.i_end:,}) x [{sm.j_begin:,}, {sm.j_end:,}); "
            f"{len(want):,} planted pairs inside it, {sum(outside.values()):,} outside it "
            f"(by blocks: {outside})")
        argv = ["--input_uri", input_dir, "--output_uri", output_dir,
                "--kin_threshold", str(THRESHOLD), "--split_factor", str(cohort.split_factor),
                "--shard_index", str(cohort.shard_index), "--device", device]
        spec = {"mode": "task", "cpus": task, "device": device, "argv": argv,
                "cohort": dataclasses.asdict(cohort)}
        parent_rss = rss_readings()
        out, task_log, wall = run_child(spec, timeout=3000)
        check(out["rc"] == 0, f"the CLI task exited {out['rc']}:\n{task_log[-4000:]}")
        peak = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss << 10
        stages = stage_seconds(task_log)
        stages["upload"] = out["upload_s"]
        stages["sweep"] = stages["king_kernel"] - out["upload_s"]
        # The task's own peak, read in the child before its checks ran.
        own, source = own_peak(out["peak_rss"])
        beside = (own - out["planes_bytes"]) / 2**20
        fit = out["fit"]
        result["task"] = {
            "wall_s": wall, "main_s": out["task_s"], "stages_s": stages,
            "steps": out["steps"], "sweep_ms_per_step": 1e3 * stages["sweep"] / out["steps"],
            "ingest_entries": out["ingest_entries"], "ingest_kept": out["ingest_kept"],
            "launches": out["launches"], "fit": fit, "panel": out["panel"],
            "rusage_children_maxrss_bytes": peak, "peak_rss_before_checks": out["peak_rss"],
            "parent_rss_before_it": parent_rss, "peak_rss_bytes": own,
            "planes_bytes": out["planes_bytes"], "stored_rows": out["stored_rows"],
            "rss_beside_planes_mib": beside,
            "rows_checked": out["rows_checked"], "sections_checked": out["sections_checked"],
            "rows_differing": out["rows_differing"][:10],
            "offsets_differing": out["offsets_differing"],
            "padding_rows": out["padding_rows"],
            "padding_not_missing": out["padding_not_missing"],
            "plane_tallies": out["plane_tallies"], "check_s": out["check_s"]}
        t = result["task"]
        say(f"task: exit 0, the process {wall:.1f} s (the CLI's main {out['task_s']:.1f} s, "
            f"the checks after it {out['check_s']:.1f} s) on {len(task)} CPUs; stages "
            + ", ".join(f"{k} {v:.3f} s" for k, v in stages.items()))
        say(f"task: allocation {stages['allocate']:.3f} s for {out['planes_bytes']:,} B of "
            f"planes ({out['stored_rows']:,} stored rows); ingest {stages['ingest']:.3f} s, "
            f"{out['ingest_entries']:,} entries read ({out['ingest_entries'] / stages['ingest'] / 1e6:.2f}M/s), "
            f"{out['ingest_kept']:,} kept; upload {stages['upload']:.3f} s "
            f"({out['planes_bytes'] / stages['upload'] / 1e9:.2f} GB/s); sweep "
            f"{stages['sweep']:.3f} s, {t['steps']:,} steps at panel {out['panel']}, "
            f"{t['sweep_ms_per_step']:.3f} ms a step")
        if "peak_device_bytes" in fit:
            say(f"task: check_engine_fit read {fit['free_bytes']:,} B free of "
                f"{fit['total_bytes']:,} B, a limit of {fit['limit_bytes']:,} B, and modelled "
                f"{fit['model_bytes']:,} B; peak device memory {fit['peak_device_bytes']:,} B, "
                f"{(fit['model_bytes'] - fit['peak_device_bytes']) / 2**20:,.1f} MiB inside "
                f"the model")
        say(f"task: launches {out['launches']}; peak RSS {own / 2**20:,.0f} MiB before the "
            f"checks, its own ({source}; its ru_maxrss {out['peak_rss']['ru_maxrss_bytes'] / 2**20:,.0f} "
            f"MiB and RUSAGE_CHILDREN {peak / 2**20:,.0f} MiB, with the checks, can hold this "
            f"process's peak, {parent_rss['ru_maxrss_bytes'] / 2**20:,.0f} MiB), "
            f"{beside:,.0f} MiB beside the planes' {out['planes_bytes'] / 2**20:,.0f} MiB "
            f"(batch_submit.py: {INGEST_TERM_MIB:,} + {PROCESS_TERM_MIB:,} MiB beside them, "
            f"{DEFAULT_MEMORY_MIB:,} MiB requested in all); checks {out['check_s']:.1f} s: "
            f"{out['rows_checked']:,} rows' planes ({out['sections_checked']} in the i / j "
            f"section), {out['padding_rows']:,} padding rows")
        got = read_output(output_dir)
        diff = row_differences(got, want)
        result["output"] = {"rows": len(got), "planted_pairs": len(want), **diff}
        say(f"output: {len(got):,} rows against {len(want):,} planted pairs in the shard: "
            f"{diff}")
        result["ingest"] = []
        plan = ingest_plan(cohort.files, ingest_runs, ab_runs, all_cpus, task)
        for run in plan:
            # Memory a child frees returns to the host over seconds: wait for
            # it before the next child allocates its planes.
            settled_host_available_bytes()
            r, _, _ = run_child(dict(run, mode="ingest", input=input_dir), timeout=3000)
            result["ingest"].append(r)
            say(f"ingest: {r['cpus']} CPUs, {r['setting']}, split {r['split_factor']}, "
                f"{r['files']} files: "
                f"{r['entries']:,} entries in {r['ingest_s']:.2f} s = "
                f"{r['entries_per_s'] / 1e6:.2f}M entries/s (allocation {r['alloc_s']:.2f} s); "
                f"{r['decoders']} decoders, {r['readers']} readers, packer threads per call "
                f"{r['packer_threads_per_call']}; summed over workers "
                + ", ".join(f"{k} {v:.2f} s" for k, v in r["split_s"].items())
                + f"; peak RSS {own_peak(r['peak_rss'])[0] / 2**20:,.0f} MiB "
                f"(ru_maxrss {r['peak_rss']['ru_maxrss_bytes'] / 2**20:,.0f})")
        result["ingest_summary"] = summarize(result["ingest"])
    finally:
        shutil.rmtree(input_dir, ignore_errors=True)
        shutil.rmtree(output_dir, ignore_errors=True)
    failures = [f"the cohort plants no pair {kind}" for kind in missing_kinds(cohort, outside)]
    if t["rows_differing"]:
        failures.append(f"planes differ from pack_genotypes in rows {t['rows_differing']}")
    if t["offsets_differing"]:
        failures.append(f"storage_offsets differs from the layout in rows {t['offsets_differing']}")
    if not cohort.submatrix.is_diagonal and min(t["sections_checked"]) == 0:
        failures.append(f"the planes check missed a section: {t['sections_checked']}")
    if t["padding_not_missing"]:
        failures.append(f"padding rows hold defined sites: {t['padding_not_missing']}")
    if t["plane_tallies"] != w["shard_tallies"]:
        failures.append(f"plane tallies {t['plane_tallies']} != the shard's written "
                        f"{w['shard_tallies']}")
    if (t["ingest_entries"], t["ingest_kept"]) != (w["entries"], w["shard_entries"]):
        failures.append(f"the task's ingest read {t['ingest_entries']} and kept "
                        f"{t['ingest_kept']} entries, not {w['entries']} and {w['shard_entries']}")
    if diff["missing"] or diff["extra"] or diff["wrong"]:
        failures.append(f"output rows differ from the planted pairs: {diff}")
    if device.startswith("cuda"):
        steps = t["steps"]
        if t["launches"] != {"king_counts": steps, "king_emit": steps}:
            failures.append(f"launches {t['launches']}, expected {steps} of each kernel")
        if not t["fit"].get("peak_device_bytes", np.inf) <= t["fit"]["model_bytes"]:
            failures.append(f"peak device memory {t['fit'].get('peak_device_bytes')} B "
                            f"over check_engine_fit's model {t['fit']['model_bytes']} B")
    per_file = np.array(w["file_entries"])
    for r in result["ingest"]:
        if r["entries"] != per_file[:r["files"]].sum():
            failures.append(f"an ingest of {r['files']} files read {r['entries']} entries")
    result["failures"] = failures
    result["ok"] = not failures
    return result


# Host memory a task takes beside its planes (cell O: 11,258-12,787 MiB on
# 8 decoders), and input bytes per Parquet entry (1.92 measured in
# chip_smoke.py phase 14), each with a margin.
HOST_RESERVE_BYTES = 16 << 30
INPUT_BYTES_PER_ENTRY = 3.0


def reckon(cohort: Cohort, workdir: str) -> tuple[Cohort, list[str]]:
    """Sizes the cut to the disk and host memory: the input at
    :data:`INPUT_BYTES_PER_ENTRY` within 90% of the free disk, the shard's
    planes and :data:`HOST_RESERVE_BYTES` within the host's available
    memory (fewer samples, the same split and shard, when they are not);
    the cohort to run and what was cut."""
    from cuking_tpu_torch.ops.bitset import PlaneLayout
    from cuking_tpu_torch.parallel.submatrix import Submatrix
    from cuking_tpu_torch.utils.hbm import engine_plane_bytes
    from tools.torch_shard_at_scale import host_available_bytes

    notes = []
    entries = cohort.written_sites * cohort.samples * 0.95
    free = shutil.disk_usage(workdir).free
    notes.append(f"input ~{entries:.3e} entries, ~{INPUT_BYTES_PER_ENTRY * entries / 1e9:.1f} GB "
                 f"at {INPUT_BYTES_PER_ENTRY} B an entry; {free / 1e9:.1f} GB free")
    if INPUT_BYTES_PER_ENTRY * entries > 0.9 * free:
        files = max(1, int(0.9 * free / (INPUT_BYTES_PER_ENTRY * entries / cohort.files)))
        notes.append(f"the disk holds {files} of {cohort.files} files: cut to {files}")
        cohort = dataclasses.replace(cohort, files=files)
    words = PlaneLayout.create(cohort.sites).words

    def planes(samples: int) -> int:
        sm = Submatrix.create(samples, cohort.split_factor, cohort.shard_index)
        return engine_plane_bytes(sm, words, PANEL)

    avail = host_available_bytes()
    notes.append(f"planes {planes(cohort.samples) / 1e9:.2f} GB; {avail / 1e9:.1f} GB of host "
                 f"memory available, {HOST_RESERVE_BYTES / 2**30:.0f} GiB kept beside them")
    if planes(cohort.samples) + HOST_RESERVE_BYTES > avail:
        lo, hi = cohort.split_factor, cohort.samples  # the shard fits at lo
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if planes(mid) + HOST_RESERVE_BYTES <= avail else (lo, mid)
        notes.append(f"the host holds the shard's planes of {lo:,} samples: cut from "
                     f"{cohort.samples:,}")
        cohort = dataclasses.replace(cohort, samples=lo)
    return cohort, notes


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--samples", type=int, default=SAMPLES)
    ap.add_argument("--sites", type=int, default=SITES)
    ap.add_argument("--files", type=int, default=FILES)
    ap.add_argument("--sites-per-file", type=int, default=None,
                    help="default: ~9.45M cells a file (63 sites at 150,000 samples)")
    ap.add_argument("--split-factor", type=int, default=1,
                    help="the task's --split_factor (default 1: the whole cohort)")
    ap.add_argument("--shard-index", type=int, default=0,
                    help="the task's --shard_index (default 0)")
    ap.add_argument("--ingest-runs", type=int, default=3,
                    help="whole-input ingest runs as the package has it (0: the task alone)")
    ap.add_argument("--ab-runs", type=int, default=2,
                    help="runs of each A/B ingest setting, in turns (0: none)")
    ap.add_argument("--device", default="cuda",
                    help="the CLI's --device (default cuda; cpu runs the plain path)")
    ap.add_argument("--workdir", default=None,
                    help="where the input is written (default: a temporary directory)")
    args = ap.parse_args(argv)

    import torch

    from cuking_tpu_torch.utils.card import card_name

    cohort = cohort_for(args.samples, args.sites, args.files, args.sites_per_file,
                        split_factor=args.split_factor, shard_index=args.shard_index)
    cohort.submatrix  # an invalid split or shard fails here, before any work
    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            print("torch_cli_at_scale: no CUDA device; pass --device cpu to run the "
                  "plain path", file=sys.stderr)
            return 2
        card = card_name()
    else:
        card = None
    print(f"card: {card}; torch {torch.__version__}; CPU {cpu_model()}, "
          f"{len(os.sched_getaffinity(0))} usable of {os.cpu_count()}", flush=True)
    workdir = tempfile.mkdtemp(prefix="cli_at_scale_", dir=args.workdir)
    try:
        cohort, notes = reckon(cohort, workdir)
        for note in notes:
            print(f"reckoned: {note}", flush=True)
        result = run_cell(cohort, workdir, device=args.device, ingest_runs=args.ingest_runs,
                          ab_runs=args.ab_runs,
                          log=lambda line: print(line, flush=True))
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    result.update(card=card, torch=torch.__version__, cpu_model=cpu_model(), reckoned=notes)
    for failure in result["failures"]:
        print(f"FAILED: {failure}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    raise SystemExit(main())
