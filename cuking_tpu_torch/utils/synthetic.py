"""Port of ``cuking_tpu/utils/synthetic.py`` (a copy; numpy only).

Synthetic genotype data for tests and benchmarks.

The reference has no test fixtures at all (SURVEY.md §4); this generator
produces dense genotype matrices with realistic allele-frequency structure,
configurable missingness, and *seeded related pairs* (duplicates and
parent-child style mixtures) so kin-threshold filtering paths actually fire.
"""

from __future__ import annotations

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
