"""The port's dense ``king()`` (cuking_tpu_torch/api.py) against the JAX
package's ``cuking_tpu.king``, bit for bit (NaN and -inf included), and
its pruning (cuking_tpu_torch/prune.py) on the cases of tests/test_prune.py,
plus the package's exports."""

import numpy as np
import pytest
import torch

import cuking_tpu
import cuking_tpu_torch
from cuking_tpu.models.king import KingConfig as JaxConfig
from cuking_tpu.models.king import KingEngine as JaxEngine
from cuking_tpu.prune import related_samples_to_drop as jax_drop
from cuking_tpu_torch import KingConfig, KingEngine, ResultSet, king, related_samples_to_drop
from cuking_tpu_torch.prune import maximal_independent_set
from cuking_tpu_torch.utils.status import FailedPreconditionError
from cuking_tpu_torch.utils.synthetic import random_genotypes


def _bits(x):
    return np.asarray(x, dtype=np.float32).view(np.uint32)


@pytest.mark.parametrize("n,sites,chunk", [(40, 700, 16), (37, 2049, 128)])
def test_king_matches_jax_bit_for_bit(n, sites, chunk):
    g = random_genotypes(n, sites, missing_rate=0.1, seed=n, num_related_pairs=3)
    g[3] = -1                           # all missing: zero counts, NaN kin
    g[4] = np.where(g[4] == 1, 2, g[4])  # no hets: min(het) = 0, -inf or NaN
    got = king(g, site_chunk_words=chunk, device="cpu")
    ref = cuking_tpu.king(g, site_chunk_words=chunk)
    kin = got.kin.numpy()
    assert np.isnan(kin[3]).all() and np.isneginf(kin[4, 5:]).any()
    assert np.array_equal(_bits(kin), _bits(ref.kin))
    for f in ("ibs0", "ibs1", "ibs2"):
        assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f))), f


def test_king_duplicates_give_one_half_and_symmetry():
    g = random_genotypes(30, 500, missing_rate=0.05, seed=12)
    g[1] = g[0]
    kin = king(g, device="cpu").kin.numpy()
    assert _bits(kin[0, 1]) == _bits(np.float32(0.5))
    finite = np.isfinite(kin)
    assert (finite == finite.T).all()
    assert np.array_equal(kin[finite], kin.T[finite])


def test_king_rejects_bad_shape_and_absent_cuda():
    with pytest.raises(ValueError, match="num_samples, num_sites"):
        king(np.zeros(5, dtype=np.int8), device="cpu")
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(FailedPreconditionError, match="needs a CUDA device"):
        king(np.zeros((4, 10), dtype=np.int8))


def test_king_takes_a_kernel_override():
    from cuking_tpu_torch.ops.king_popcount import panel_counts_popcount

    g = random_genotypes(21, 333, missing_rate=0.1, seed=3, num_related_pairs=2)
    got = king(g, kernel=panel_counts_popcount, device="cpu")
    assert np.array_equal(_bits(got.kin), _bits(king(g, device="cpu").kin))


def test_package_exports_the_jax_names():
    names = ("king", "related_samples_to_drop", "KingConfig", "KingEngine",
             "ResultSet", "KingCounts", "KingResult", "Submatrix")
    for name in names:
        assert hasattr(cuking_tpu, name)
        assert getattr(cuking_tpu_torch, name).__module__.startswith("cuking_tpu_torch.")


# -- pruning: the cases of tests/test_prune.py --------------------------------


def _is_independent(keep, edges):
    return not any(a in keep and b in keep for a, b in edges)


def _assert_maximal(keep, edges):
    adj = {}
    for a, b in edges:
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set()).add(a)
    assert all(adj[v] & keep for v in set(adj) - keep)


def test_mis_star_graph():
    assert maximal_independent_set(np.array([0, 0, 0, 0]), np.array([1, 2, 3, 4])) == {1, 2, 3, 4}


def test_mis_chain_and_maximality():
    i, j = np.array([0, 1, 2, 3]), np.array([1, 2, 3, 4])
    keep = maximal_independent_set(i, j)
    edges = list(zip(i.tolist(), j.tolist()))
    assert _is_independent(keep, edges)
    _assert_maximal(keep, edges)


def test_mis_random_graphs_independent_and_maximal():
    rng = np.random.default_rng(0)
    for _ in range(10):
        n = int(rng.integers(5, 40))
        m = int(rng.integers(1, 3 * n))
        i, j = rng.integers(0, n, m), rng.integers(0, n, m)
        sel = i != j
        i, j = i[sel], j[sel]
        if not len(i):
            continue
        keep = maximal_independent_set(i, j)
        edges = list(zip(i.tolist(), j.tolist()))
        assert _is_independent(keep, edges)
        _assert_maximal(keep, edges)


def test_related_samples_to_drop_end_to_end_matches_jax():
    g = random_genotypes(40, 600, missing_rate=0.05, seed=17, num_related_pairs=4)
    results = KingEngine.from_genotypes(
        g, KingConfig(kin_threshold=0.2, panel=16, device="cpu")).run()
    assert len(results) == 4  # the seeded pairs
    drop = related_samples_to_drop(results)
    assert len(drop) == 4
    assert not [(a, b) for a, b in zip(results.i_idx, results.j_idx)
                if a not in drop and b not in drop]
    ref = JaxEngine.from_genotypes(g, JaxConfig(kin_threshold=0.2, kernel="matmul",
                                                panel=16, site_chunk_words=16)).run()
    assert drop == jax_drop(ref)


def test_tie_breaker_orders_equal_degree_removals():
    """Hail semantics: a negative return removes the first node first."""
    i, j = np.array([0, 1, 2, 3]), np.array([1, 2, 3, 0])
    rank = {0: 0.0, 1: 3.0, 2: 1.0, 3: 2.0}
    assert maximal_independent_set(i, j, tie_breaker=lambda l, r: rank[r] - rank[l]) == {0, 2}
    assert maximal_independent_set(i, j, tie_breaker=lambda l, r: rank[l] - rank[r]) == {1, 3}
    assert maximal_independent_set(i, j) == maximal_independent_set(i, j)


def test_tie_breaker_through_related_samples_to_drop():
    z = np.zeros(2, np.int32)
    rs = ResultSet(i_idx=np.array([5, 5], np.int32), j_idx=np.array([7, 9], np.int32),
                   kin=np.full(2, 0.5, np.float32), ibs0=z, ibs1=z.copy(), ibs2=z.copy())
    assert related_samples_to_drop(rs, tie_breaker=lambda l, r: l - r) == {5}
