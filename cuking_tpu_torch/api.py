"""Port of ``cuking_tpu/api.py``: the ``hl.king``-shaped dense API.

The reference's acceptance criterion is parity with Hail's ``hl.king``
(README.md:3), which returns a full N×N kinship matrix.  The pipeline
surface (CLI / KingEngine) returns thresholded sparse pairs like the
reference binary; this is the dense twin for library users and
validation::

    import cuking_tpu_torch
    res = cuking_tpu_torch.king(genotypes)   # [N, S]: 0/1/2, -1 = missing
    res.kin[i, j], res.ibs0[i, j], ...      # full [N, N] matrices

Semantics match cuking.cu:286-307 exactly.  Pairs with ``min(het) == 0``
give IEEE inf/NaN, as in the reference.  The device is explicit: on a CUDA
device the counts come from the CUDA kernel's sliced entry, on the CPU from
its plain version; a CUDA device that is absent is an error, not a CPU run.
"""

from __future__ import annotations

import numpy as np
import torch

from cuking_tpu_torch.ops import bitset
from cuking_tpu_torch.ops.bitset import PlaneLayout
from cuking_tpu_torch.ops.king_cuda import panel_counts_cuda
from cuking_tpu_torch.ops.king_math import KingResult, king_from_counts
from cuking_tpu_torch.ops.king_mm import panel_counts_matmul
from cuking_tpu_torch.utils.status import FailedPreconditionError


def king(
    genotypes: np.ndarray,
    *,
    kernel=None,
    site_chunk_words: int = 128,
    device="cuda",
) -> KingResult:
    """Computes the full pairwise KING kinship + IBS matrices.

    Args:
      genotypes: ``[N, S]`` int array of alt-allele counts (0, 1, 2) with
        ``-1`` marking missing calls — the dense equivalent of the sparse
        ``n_alt_alleles`` input table.
      kernel: optional override ``(planes_i, planes_j) -> KingCounts`` on
        ``[2, N, W]`` int32 planes; by default the CUDA kernel on a CUDA
        device and the plain int8 product on the CPU.
      site_chunk_words: site-chunking granularity of the plain version.
      device: the torch device that computes (default ``cuda``).

    Returns:
      KingResult of ``[N, N]`` tensors on ``device``: ``kin`` float32,
      ``ibs0/1/2`` int32.
    """
    g = np.asarray(genotypes)
    if g.ndim != 2:
        raise ValueError(f"genotypes must be [num_samples, num_sites], got {g.shape}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise FailedPreconditionError(
            f"king(device={str(device)!r}) needs a CUDA device, and none is "
            "available; pass device='cpu' to run the plain PyTorch path."
        )
    packed = bitset.pack_genotypes(g, PlaneLayout.create(g.shape[1]))
    planes = torch.from_numpy(packed.view(np.int32)).to(device)
    if kernel is not None:
        counts = kernel(planes, planes)
    elif device.type == "cuda":
        counts = panel_counts_cuda(planes, planes)
    else:
        counts = panel_counts_matmul(planes, planes, site_chunk_words=site_chunk_words)
    return king_from_counts(counts)
