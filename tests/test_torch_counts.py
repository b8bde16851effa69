"""The port's count entries (ops/king_cuda.py) against the JAX package's
Pallas kernel (interpret mode, as tests/test_king_kernels.py runs it) and the
numpy oracle, exactly; and the port's popcount path (ops/king_popcount.py)
against the JAX package's ``panel_counts_popcount``.

On the CPU both entries take the plain PyTorch version (ops/king_mm.py); the
kernel itself is held against that version on the card by
tests/test_torch_gpu.py and chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuking_tpu.ops.king_jnp import panel_counts_popcount as jax_popcount
from cuking_tpu.ops.king_pallas import panel_counts_pallas, panel_counts_pallas_indexed
from cuking_tpu_torch.ops.bitset import PlaneLayout, pack_genotypes
from cuking_tpu_torch.ops.king_cuda import panel_counts_cuda, panel_counts_cuda_indexed
from cuking_tpu_torch.ops.king_mm import panel_counts_matmul
from cuking_tpu_torch.ops.king_popcount import panel_counts_popcount, popcount32
from cuking_tpu_torch.ops.oracle import oracle_counts
from cuking_tpu_torch.utils.status import InvalidArgumentError
from cuking_tpu_torch.utils.synthetic import random_genotypes

PALLAS = dict(site_chunk_words=8, tile_i=8, tile_j=8, interpret=True)


def _planes(rows, num_sites, seed):
    g = random_genotypes(rows, num_sites, missing_rate=0.12, seed=seed,
                         num_related_pairs=2)
    return g, pack_genotypes(g, PlaneLayout.create(num_sites))


def _t(planes_np):
    return torch.from_numpy(planes_np.view(np.int32))


def _assert_counts_equal(got, exp, upper=False):
    for name, g, e in zip(got._fields, got, exp):
        g, e = np.asarray(g), np.asarray(e)
        if upper:  # tri: only pairs with i < j are defined
            keep = np.triu(np.ones(g.shape, bool), 1)
            g, e = g[keep], e[keep]
        assert np.array_equal(g, e), name


# sites, storage rows, i_off, j_off, panel, panel_j, separate planes_j, tri
CASES = [
    (100, 32, 8, 16, 16, 16, False, 0),
    (1023, 40, 0, 8, 16, 24, True, 0),
    (2049, 48, 8, 24, 16, 8, False, 0),
    (1023, 32, 8, 8, 16, 16, False, 1),
]


@pytest.mark.parametrize("sites,rows,i_off,j_off,panel,panel_j,separate,tri", CASES)
def test_indexed_entry_matches_pallas_and_oracle(
    sites, rows, i_off, j_off, panel, panel_j, separate, tri
):
    g, planes = _planes(rows, sites, seed=sites)
    g_j, planes_j = _planes(rows, sites, seed=sites + 1) if separate else (g, planes)
    got = panel_counts_cuda_indexed(
        _t(planes), i_off, j_off, tri, panel,
        planes_j=_t(planes_j) if separate else None, panel_j=panel_j)
    ref = panel_counts_pallas_indexed(
        jnp.asarray(planes), i_off, j_off, jnp.int32(tri), panel,
        planes_j=jnp.asarray(planes_j) if separate else None, panel_j=panel_j,
        **PALLAS)
    exp = oracle_counts(g[i_off:i_off + panel], g_j[j_off:j_off + panel_j])
    _assert_counts_equal(got, ref, upper=bool(tri))
    _assert_counts_equal(got, exp, upper=bool(tri))


@pytest.mark.parametrize("sites,ni,nj", [(100, 8, 16), (1023, 16, 24), (2049, 24, 8)])
def test_sliced_entry_matches_pallas_and_oracle(sites, ni, nj):
    g, planes = _planes(ni + nj, sites, seed=7 * sites)
    pi, pj = planes[:, :ni].copy(), planes[:, ni:].copy()
    got = panel_counts_cuda(_t(pi), _t(pj))
    ref = panel_counts_pallas(jnp.asarray(pi), jnp.asarray(pj), **PALLAS)
    _assert_counts_equal(got, ref)
    _assert_counts_equal(got, oracle_counts(g[:ni], g[ni:]))


@pytest.mark.parametrize("chunk", [1, 5, 128])
def test_plain_version_ragged_site_chunks(chunk):
    """The plain version's site chunks need not divide W."""
    g, planes = _planes(20, 2049, seed=3)
    got = panel_counts_matmul(_t(planes[:, :12]), _t(planes[:, 12:]),
                              site_chunk_words=chunk)
    _assert_counts_equal(got, oracle_counts(g[:12], g[12:]))


def test_entries_check_their_inputs():
    planes = torch.zeros((2, 16, 4), dtype=torch.int32)
    with pytest.raises(InvalidArgumentError, match="out of bounds"):
        panel_counts_cuda_indexed(planes, 8, 0, 0, 16)
    with pytest.raises(InvalidArgumentError, match="int32 view"):
        panel_counts_cuda_indexed(planes.to(torch.int64), 0, 0, 0, 8)
    with pytest.raises(InvalidArgumentError, match="W=4, planes_j W=8"):
        panel_counts_cuda(planes, torch.zeros((2, 16, 8), dtype=torch.int32))


@pytest.mark.parametrize("sites,ni,nj,row_block", [
    (100, 8, 16, 8), (1023, 16, 24, 3), (2049, 24, 8, 8), (700, 5, 7, 16),
])
def test_popcount_path_matches_jax_popcount(sites, ni, nj, row_block):
    """Row blocks that divide NI, that do not (a ragged last block), and
    that exceed it."""
    g, planes = _planes(ni + nj, sites, seed=11 * sites)
    pi, pj = planes[:, :ni].copy(), planes[:, ni:].copy()
    got = panel_counts_popcount(_t(pi), _t(pj), row_block=row_block)
    ref = jax_popcount(jnp.asarray(pi), jnp.asarray(pj), row_block=8)
    _assert_counts_equal(got, ref)
    _assert_counts_equal(got, oracle_counts(g[:ni], g[ni:]))


def test_popcount32_on_sign_bits():
    """SWAR on the int32 view: words with the sign bit set count right."""
    words = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0xDEADBEEF,
                      0x55555555, 0xAAAAAAAA], dtype=np.uint32)
    got = popcount32(torch.from_numpy(words.view(np.int32))).tolist()
    assert got == [bin(int(w)).count("1") for w in words]
