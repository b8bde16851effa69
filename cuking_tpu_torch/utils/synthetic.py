"""Port of ``cuking_tpu/utils/synthetic.py`` (a copy; numpy only).

Synthetic genotype data for tests and benchmarks.  The generators at the
end (``random_planes``, ``edge_planes``, ``random_counters``,
``plant_clone_families``, ``rows_past_word_limits``) are the port's own:
they write het/hom words, or KING counters, directly, without genotypes in
between.

The reference has no test fixtures at all (SURVEY.md §4); this generator
produces dense genotype matrices with realistic allele-frequency structure,
configurable missingness, and *seeded related pairs* (duplicates and
parent-child style mixtures) so kin-threshold filtering paths actually fire.
"""

from __future__ import annotations

import itertools

import numpy as np


def random_genotypes(
    num_samples: int,
    num_sites: int,
    *,
    missing_rate: float = 0.05,
    seed: int = 0,
    num_related_pairs: int = 0,
) -> np.ndarray:
    """Dense [N, S] int8 genotypes: 0/1/2, -1 = missing.

    Sites get allele frequencies ~ Uniform(0.05, 0.5); genotypes are
    Hardy-Weinberg draws, so unrelated pairs have kin ≈ 0.  The last
    ``2 * num_related_pairs`` samples are overwritten with pairs that share
    ~90% of their genotypes (kin well above the 0.354 duplicate threshold's
    lower bound and above 0.0884 second-degree default).
    """
    rng = np.random.default_rng(seed)
    freqs = rng.uniform(0.05, 0.5, size=num_sites)
    # Two independent allele draws per site per sample.
    g = (
        (rng.random((num_samples, num_sites)) < freqs).astype(np.int8)
        + (rng.random((num_samples, num_sites)) < freqs).astype(np.int8)
    )

    for k in range(num_related_pairs):
        a = num_samples - 2 * k - 2
        b = num_samples - 2 * k - 1
        if a < 0:
            break
        keep = rng.random(num_sites) < 0.9
        g[b, keep] = g[a, keep]

    if missing_rate > 0:
        mask = rng.random((num_samples, num_sites)) < missing_rate
        g[mask] = -1
    return g


def genotypes_to_coo(
    genotypes: np.ndarray, *, shuffle: bool = True, seed: int = 0
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dense genotypes → sparse (row_idx=site, col_idx=sample, n_alt_alleles)
    COO triples, missing entries omitted — the reference's input contract
    (mt_to_cuking_inputs.py:26-28, README.md:13-31).
    """
    sample_idx, site_idx = np.nonzero(genotypes >= 0)
    n_alt = genotypes[sample_idx, site_idx].astype(np.int32)
    row_idx = site_idx.astype(np.int64)  # row = genomic site
    col_idx = sample_idx.astype(np.int64)  # col = sample
    if shuffle:
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(n_alt))
        row_idx, col_idx, n_alt = row_idx[order], col_idx[order], n_alt[order]
    return row_idx, col_idx, n_alt


def padding_mask(layout) -> np.ndarray:
    """[W] uint32: the bits of each word of ``layout`` (a ``PlaneLayout``)
    that hold padding sites (site s = b·W + w ≥ num_sites), which must read
    as missing."""
    w = np.arange(layout.words, dtype=np.int64)
    mask = np.zeros(layout.words, dtype=np.uint32)
    for b in range(32):
        mask |= np.where(b * layout.words + w >= layout.num_sites,
                         np.uint32(1 << b), np.uint32(0))
    return mask


def fill_random_planes(planes: np.ndarray, layout, rng, block: int = 4096) -> None:
    """Uniform random het/hom bits into ``planes`` ([2, rows, W] uint32), so
    1/4 of the sites are missing, padding sites set missing; written in row
    blocks to bound host memory."""
    pad = padding_mask(layout)
    for lo in range(0, planes.shape[1], block):
        hi = min(lo + block, planes.shape[1])
        planes[:, lo:hi] = rng.integers(
            0, 1 << 32, size=(2, hi - lo, layout.words), dtype=np.uint32) | pad


def random_planes(rows: int, layout, rng) -> np.ndarray:
    """[2, rows, W] uint32 planes of :func:`fill_random_planes`."""
    planes = np.empty((2, rows, layout.words), dtype=np.uint32)
    fill_random_planes(planes, layout, rng)
    return planes


def edge_planes(rows: int, layout, rng) -> np.ndarray:
    """Random planes whose first 6 rows are all missing, all het, all
    hom-ref, all hom-alt, and two rows whose words have the sign bit set
    (het at the bit-31 sites and hom-ref elsewhere; hom-alt at the bit-31
    sites and hom-ref elsewhere).  Padding sites stay missing."""
    planes = random_planes(rows, layout, rng)
    pad = padding_mask(layout)
    ones = np.full(layout.words, 0xFFFFFFFF, np.uint32)
    sign = np.uint32(0x80000000) | pad
    for row, (het, hom) in enumerate([(ones, ones), (ones, pad), (pad, pad),
                                      (pad, ones), (sign, pad), (pad, sign)]):
        planes[0, row], planes[1, row] = het, hom
    return planes


def random_counters(ni: int, nj: int, rng, ties=()) -> np.ndarray:
    """[6, ni, nj] int32 KING counters (both_het, het_i, het_j,
    opposing_hom, concordant_hom, shared_sites) that a panel pair could give
    (both_het <= min(het_i, het_j)), with the emit step's edge cases: row 1
    and column 2 have no hets, so their kin is -inf, or NaN (0/0) where
    opposing_hom is 0 too (every other pair of row 1 and, at column 2, the
    rest).  Every pair of ``ties`` (``(li, lj)`` tuples) gets the same
    counters, with a finite kin, so a threshold set to that kin ties them."""
    hi = rng.integers(0, 60, (ni, nj))
    hj = rng.integers(0, 60, (ni, nj))
    hi[1], hj[:, 2] = 0, 0
    bh = rng.integers(0, np.minimum(hi, hj) + 1)
    oh = rng.integers(0, 25, (ni, nj))
    oh[1, ::2] = 0
    ch = rng.integers(0, 900, (ni, nj))
    shared = bh + oh + ch + rng.integers(0, 300, (ni, nj))
    counters = np.stack([bh, hi, hj, oh, ch, shared]).astype(np.int32)
    for li, lj in ties:
        counters[:, li, lj] = (7, 30, 40, 3, 500, 700)
    return counters


def plant_clone_families(planes: np.ndarray, groups) -> list[tuple[int, int]]:
    """Copies the first row of each group in ``groups`` (sequences of row
    indices) into the group's other rows of ``planes`` ([2, rows, W]), in
    place, and returns every pair (i < j) of rows that are then copies of
    one another, sorted: the hits a sweep must return, each with kin
    exactly 0.5.  A group may start at a row that an earlier group copied
    from or into (``(0, rows - 1)`` after ``range(0, 4)`` makes a family of
    5); it may not overwrite a row that another family started from."""
    source: dict[int, int] = {}
    for group in groups:
        first, *rest = (int(r) for r in group)
        for r in rest:
            planes[:, r] = planes[:, first]
            source[r] = source.get(first, first)
    families: dict[int, set] = {}
    for row, src in source.items():
        families.setdefault(src, {src}).add(row)
    return sorted(pair for rows in families.values()
                  for pair in itertools.combinations(sorted(rows), 2))


def rows_past_word_limits(rows: int, words: int) -> tuple[int, int]:
    """For [2, rows, words] planes in one buffer (het plane first): the
    first het row whose words all lie at or past flat word 2^31, and the
    first hom row whose words all lie at or past word 2^32.  These are the
    first rows that a signed, and an unsigned, 32-bit word index cannot
    reach.  ``rows`` when no such row exists; the row before each result
    straddles the limit."""
    het = -(-(1 << 31) // words)
    hom = max(0, -(-((1 << 32) - rows * words) // words))
    return min(het, rows), min(hom, rows)
