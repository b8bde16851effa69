"""The CUDA count kernel against its plain PyTorch version, on the card.

Marked ``gpu``: a CUDA kernel has no CPU mode, so these skip where
``torch.cuda.is_available()`` is false.  This file imports no jax, so it also
runs on a GPU machine without the JAX package's dependencies::

    python -m pytest tests/test_torch_gpu.py -m gpu
"""

import numpy as np
import pytest
import torch

from cuking_tpu_torch.ops import king_cuda
from cuking_tpu_torch.ops.bitset import PlaneLayout, pack_genotypes
from cuking_tpu_torch.ops.king_cuda import panel_counts_cuda, panel_counts_cuda_indexed
from cuking_tpu_torch.models.king import KingConfig, KingEngine
from cuking_tpu_torch.ops.king_mm import panel_counts_matmul
from cuking_tpu_torch.parallel.ring import (
    RingMesh,
    all_pairs_sharded,
    ring_output_to_resultset,
)
from cuking_tpu_torch.utils.synthetic import random_genotypes


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("sites,i_off,j_off,panel,panel_j,tri", [
    (100_000, 100, 1100, 1024, 1024, 0),
    (3_100, 17, 1100, 1000, 700, 0),
    (3_100, 256, 256, 1024, 1024, 1),
])
def test_cuda_kernel_matches_plain_version(cuda_device, sites, i_off, j_off,
                                           panel, panel_j, tri):
    rng = np.random.default_rng(sites)
    layout = PlaneLayout.create(sites)
    planes_np = rng.integers(0, 1 << 32, size=(2, 2200, layout.words),
                             dtype=np.uint32)
    planes = torch.from_numpy(planes_np.view(np.int32)).to(cuda_device)
    got = panel_counts_cuda_indexed(planes, i_off, j_off, tri, panel,
                                    panel_j=panel_j)
    exp = panel_counts_matmul(planes[:, i_off:i_off + panel],
                              planes[:, j_off:j_off + panel_j])
    torch.cuda.synchronize()
    for name, g, e in zip(got._fields, got, exp):
        if tri:  # only pairs with i < j are defined
            keep = torch.ones_like(g, dtype=torch.bool).triu(1)
            g, e = g[keep], e[keep]
        assert torch.equal(g, e), name


@pytest.mark.gpu
def test_cuda_sliced_entry_counts_its_launch(cuda_device):
    rng = np.random.default_rng(5)
    planes = torch.from_numpy(
        rng.integers(0, 1 << 32, size=(2, 300, 100), dtype=np.uint32).view(np.int32)
    ).to(cuda_device)
    pi, pj = planes[:, :130].contiguous(), planes[:, 130:].contiguous()
    before = king_cuda.launches
    got = panel_counts_cuda(pi, pj)
    assert king_cuda.launches == before + 1
    exp = panel_counts_matmul(pi, pj)
    for name, g, e in zip(got._fields, got, exp):
        assert torch.equal(g, e), name


@pytest.mark.gpu
@pytest.mark.parametrize("positions,sub_panel", [(3, 64), (4, 64), (4, None)])
def test_ring_on_one_card_equals_the_engine(cuda_device, positions, sub_panel):
    """The ring with every position on cuda:0 (odd D; even D with sub-tiled
    and with single-tile wrap steps, the latter reading the visitor at row
    offset p1) returns the cuda engine's keep-all results exactly."""
    g = random_genotypes(300, 3_000, missing_rate=0.05, seed=positions,
                         num_related_pairs=4)
    layout = PlaneLayout.create(3_000)
    before = king_cuda.launches
    out = all_pairs_sharded(
        pack_genotypes(g, layout), 300, RingMesh([cuda_device] * positions),
        panel_counts_cuda, kin_threshold=-2.0, capacity_per_device=1 << 16,
        sub_panel=sub_panel, indexed_kernel=panel_counts_cuda_indexed)
    assert king_cuda.launches > before
    got = ring_output_to_resultset(out)
    ref = KingEngine.from_genotypes(
        g, KingConfig(kernel="cuda", device="cuda", panel=128, kin_threshold=-2.0)).run()
    assert len(got) == len(ref) > 0
    for f in ("i_idx", "j_idx", "ibs0", "ibs1", "ibs2"):
        assert np.array_equal(getattr(got, f), getattr(ref, f)), f
    assert np.array_equal(got.kin.view(np.uint32), ref.kin.view(np.uint32))
