"""The port's count entries (ops/king_cuda.py) against the JAX package's
Pallas kernel (interpret mode, as tests/test_king_kernels.py runs it) and the
numpy oracle, exactly; and the port's popcount path (ops/king_popcount.py)
against the JAX package's ``panel_counts_popcount``.

On the CPU both entries take the kernel's plain version,
``king_cuda.panel_counts_five_block``; the kernel itself is held against
that version on the card by tests/test_torch_gpu.py and chip_smoke.py.
Every storage carries edge rows (all missing, all het, all hom-ref, all
hom-alt, and rows whose words have the sign bit set) among its random
rows."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cuking_tpu.ops.king_jnp import panel_counts_popcount as jax_popcount
from cuking_tpu.ops.king_pallas import panel_counts_pallas, panel_counts_pallas_indexed
from cuking_tpu_torch.ops.bitset import PlaneLayout, pack_genotypes
from cuking_tpu_torch.ops import king_cuda
from cuking_tpu_torch.ops.king_cuda import (
    panel_counts_cuda,
    panel_counts_cuda_indexed,
    panel_counts_five_block,
)
from cuking_tpu_torch.ops.king_mm import panel_counts_matmul
from cuking_tpu_torch.ops.king_popcount import panel_counts_popcount, popcount32
from cuking_tpu_torch.ops.oracle import oracle_counts
from cuking_tpu_torch.utils.status import InvalidArgumentError
from cuking_tpu_torch.utils.synthetic import edge_planes, padding_mask, random_genotypes

PALLAS = dict(site_chunk_words=8, tile_i=8, tile_j=8, interpret=True)


def _edge_rows(layout):
    """[6, S] genotypes: all missing, all het, all hom-ref, all hom-alt, and
    two rows whose bit-31 sites (s // W == 31) differ from the rest, so their
    het or hom words have the sign bit set and the others do not."""
    top = np.arange(layout.num_sites) // layout.words == 31
    return np.stack([
        np.full(layout.num_sites, -1), np.full(layout.num_sites, 1),
        np.full(layout.num_sites, 0), np.full(layout.num_sites, 2),
        np.where(top, 1, 2), np.where(top, 2, 0),
    ]).astype(np.int8)


# Storage rows that hold the edge rows: inside every case's i and j ranges.
EDGE_AT = (9, 25)


def _planes(rows, num_sites, seed):
    g = random_genotypes(rows, num_sites, missing_rate=0.12, seed=seed,
                         num_related_pairs=2)
    layout = PlaneLayout.create(num_sites)
    for r in EDGE_AT:
        if r + 6 <= rows:
            g[r:r + 6] = _edge_rows(layout)
    return g, pack_genotypes(g, layout)


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
    (4000, 40, 16, 8, 24, 32, True, 0),
    (129, 40, 0, 0, 40, 40, False, 1),
    (96, 40, 16, 0, 24, 16, True, 0),
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


@pytest.mark.parametrize("sites,ni,nj,chunk", [
    (100, 8, 24, 128), (1023, 16, 24, 5), (2049, 24, 16, 128), (4000, 24, 16, 7),
])
def test_five_block_plain_version_matches_pallas_and_oracle(sites, ni, nj, chunk):
    """The kernel's plain version by itself, with ragged site chunks."""
    g, planes = _planes(ni + nj, sites, seed=13 * sites)
    pi, pj = planes[:, :ni].copy(), planes[:, ni:].copy()
    got = panel_counts_five_block(_t(pi), _t(pj), site_chunk_words=chunk)
    ref = panel_counts_pallas(jnp.asarray(pi), jnp.asarray(pj), **PALLAS)
    _assert_counts_equal(got, ref)
    _assert_counts_equal(got, oracle_counts(g[:ni], g[ni:]))
    _assert_counts_equal(got, panel_counts_matmul(_t(pi), _t(pj)))


def test_cpu_entries_take_the_five_block_plain_version(monkeypatch):
    """On the CPU both entries run ``panel_counts_five_block`` on their row
    ranges, and neither launches a kernel."""
    calls = []

    def spy(planes_i, planes_j, site_chunk_words=128):
        calls.append((planes_i.shape[1], planes_j.shape[1]))
        return panel_counts_five_block(planes_i, planes_j, site_chunk_words)

    monkeypatch.setattr(king_cuda, "panel_counts_five_block", spy)
    g, planes = _planes(40, 300, seed=5)
    before = king_cuda.launches
    got = panel_counts_cuda_indexed(_t(planes), 8, 16, 0, 16, panel_j=24)
    _assert_counts_equal(got, oracle_counts(g[8:24], g[16:40]))
    got = panel_counts_cuda(_t(planes[:, :8].copy()), _t(planes[:, 8:].copy()))
    _assert_counts_equal(got, oracle_counts(g[:8], g[8:]))
    assert calls == [(16, 24), (8, 32)]
    assert king_cuda.launches == before


def _kernel_computes(bx, by, ni, nj, tri):
    """The CUDA kernel's own test of whether CTA (bx, by) computes pairs
    (``computes`` in ``king_counts_wgmma_kernel``)."""
    i0, j0 = king_cuda.TILE_I * by, king_cuda.TILE_J * bx
    return i0 < ni and not (tri and i0 >= j0 + king_cuda.TILE_J - 1)


ROLE_SHAPES = [(ni, nj, False) for ni in (1, 100, 128, 129, 300, 1024)
               for nj in (1, 65, 700, 1024)] + [
    (n, n, True) for n in (1, 63, 100, 128, 129, 300, 1000, 1024)]


@pytest.mark.parametrize("ni,nj,tri", ROLE_SHAPES)
def test_cluster_roles_match_a_walk_over_the_tiles(ni, nj, tri):
    """The host's count of the kernel's CTAs by role equals a walk over the
    launch's tiles, the i tiles rounded up to whole 2-CTA clusters: every
    pair to compute (any pair, with ``tri`` any i < j) lies in exactly one
    computing CTA, and a helper stands only beside a computing peer."""
    tiles_i = -(-ni // king_cuda.TILE_I)
    tiles_j = -(-nj // king_cuda.TILE_J)
    rows = -(-tiles_i // king_cuda.CLUSTER) * king_cuda.CLUSTER
    covered = np.zeros((rows * king_cuda.TILE_I, tiles_j * king_cuda.TILE_J), np.int32)
    computing = helpers = 0
    for bx in range(tiles_j):
        for y0 in range(0, rows, king_cuda.CLUSTER):
            cluster = [_kernel_computes(bx, y, ni, nj, tri)
                       for y in range(y0, y0 + king_cuda.CLUSTER)]
            for y, computes in enumerate(cluster, y0):
                if computes:
                    computing += 1
                    covered[y * king_cuda.TILE_I:(y + 1) * king_cuda.TILE_I,
                            bx * king_cuda.TILE_J:(bx + 1) * king_cuda.TILE_J] += 1
                elif any(cluster):
                    helpers += 1
    need = np.ones((ni, nj), bool)
    if tri:
        need = np.triu(need, 1)
    assert (covered[:ni, :nj][need] == 1).all()
    assert covered.max() <= 1
    assert king_cuda.cluster_roles(ni, nj, tri) == (computing, helpers)


def test_cluster_roles_of_the_sweep_cells_steps():
    """A 1024 x 1024 step: off the diagonal 128 computing CTAs and no
    helper; on the diagonal (``tri``) 72 computing beside 8 helpers, one in
    every other column of tiles."""
    assert king_cuda.cluster_roles(1024, 1024, False) == (128, 0)
    assert king_cuda.cluster_roles(1024, 1024, True) == (72, 8)
    assert king_cuda.cluster_roles(100, 1024, False) == (16, 16)
    assert king_cuda.cluster_roles(300, 700, False) == (33, 11)


def test_entries_check_their_inputs():
    planes = torch.zeros((2, 16, 4), dtype=torch.int32)
    with pytest.raises(InvalidArgumentError, match="out of bounds"):
        panel_counts_cuda_indexed(planes, 8, 0, 0, 16)
    with pytest.raises(InvalidArgumentError, match="int32 view"):
        panel_counts_cuda_indexed(planes.to(torch.int64), 0, 0, 0, 8)
    with pytest.raises(InvalidArgumentError, match="W=4, planes_j W=8"):
        panel_counts_cuda(planes, torch.zeros((2, 16, 8), dtype=torch.int32))


@pytest.mark.parametrize("sites", [128, 1000, 3100])
def test_edge_planes_pack_the_edge_rows(sites):
    """``edge_planes`` (chip_smoke.py and the GPU tests) writes its six edge
    rows as ``pack_genotypes`` packs them, sign bits included, and leaves
    the padding sites of every row missing."""
    layout = PlaneLayout.create(sites)
    planes = edge_planes(10, layout, np.random.default_rng(sites))
    top = np.arange(sites) // layout.words == 31
    g = np.stack([np.full(sites, -1), np.full(sites, 1), np.full(sites, 0),
                  np.full(sites, 2), np.where(top, 1, 0), np.where(top, 2, 0)])
    assert np.array_equal(planes[:, :6], pack_genotypes(g.astype(np.int8), layout))
    assert (planes[0, 4] >> 31).all() and (planes[1, 5] >> 31).all()
    pad = padding_mask(layout)
    assert np.array_equal(planes & pad, np.broadcast_to(pad, planes.shape))


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
