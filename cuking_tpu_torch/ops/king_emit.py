"""The emit step of the sweep: one panel pair's six KING counters →
thresholded hits appended to a :class:`~cuking_tpu_torch.ops.compaction.HitBuffer`.

This is what the JAX sweep does after each count kernel, fused by XLA:
``king_from_counts``, the ``valid & i < j & kin > threshold`` mask and
``accumulate_hits`` (``cuking_tpu/models/king.py`` ``_pair_compute``,
``cuking_tpu/ops/compaction.py``).  :func:`emit_hits` on a CUDA tensor
launches the emit kernel (``csrc/king_emit.cu``: one thread per pair, one
atomic slot reservation per CTA) and nothing else, so a sweep never waits
for the device.  On a CPU tensor it takes the plain version,
:func:`emit_hits_plain`.  Any other device raises; nothing falls back.
``emit_launches`` counts the kernel's launches.

Arguments of both: ``gi_base``/``gj_base`` are the global indices of the
counters' first row and column; a pair is a candidate when its global
``i < i_limit`` and ``j < j_limit`` and, with ``strict``, ``i < j``
(cuking.cu:199); a hit has ``kin > threshold`` (float32, cuking.cu:297);
with ``sym`` a hit is written as ``(min(i, j), max(i, j))``.
"""

from __future__ import annotations

import numpy as np
import torch

from cuking_tpu_torch.ops import king_cuda
from cuking_tpu_torch.ops.compaction import HitBuffer, compact_hits
from cuking_tpu_torch.ops.king_math import KingCounts, king_from_counts
from cuking_tpu_torch.utils.status import InvalidArgumentError, UnknownError

# Kernel launches since import (or since a caller reset them to 0).
emit_launches = 0

# The kernel's grid is one 512-thread CTA per 512 pairs, at most 2^31 - 1.
_MAX_PAIRS = (2**31 - 1) * 512


def emit_hits_plain(
    counts: KingCounts, hits: HitBuffer, gi_base: int, gj_base: int,
    i_limit: int, j_limit: int, threshold: float, strict: bool, sym: bool,
) -> None:
    """The emit kernel's plain version: the fp32 epilogue, the mask,
    ``nonzero`` and a gather of the hits (:func:`compact_hits`), written at
    the buffer's running count, which it advances in place."""
    res = king_from_counts(counts)
    ni, nj = res.kin.shape
    gi = gi_base + torch.arange(ni, device=res.kin.device)[:, None]
    gj = gj_base + torch.arange(nj, device=res.kin.device)[None, :]
    mask = (gi < i_limit) & (gj < j_limit) & (
        res.kin > torch.tensor(threshold, dtype=torch.float32)
    )
    if strict:
        mask &= gi < gj
    rows = compact_hits(mask, gi_base, gj_base, res)
    if sym:
        rows[:2] = rows[:2].sort(dim=0).values
    hits.append(rows)


def _check(counts: KingCounts, hits: HitBuffer) -> None:
    shape, device = counts.both_het.shape, counts.both_het.device
    for name, c in zip(counts._fields, counts):
        if c.dim() != 2 or c.shape != shape or c.dtype != torch.int32:
            raise InvalidArgumentError(
                f"counter {name} must be [ni, nj] int32 like both_het "
                f"{tuple(shape)}; got {tuple(c.shape)} {c.dtype}"
            )
        if c.device != device:
            raise InvalidArgumentError(
                f"counters on different devices: {device}, {c.device}"
            )
    if hits.buf.device != device or hits.count.device != device:
        raise InvalidArgumentError(
            f"the hit buffer is on {hits.buf.device}, the counters on {device}"
        )
    if hits.buf.dtype != torch.int32 or hits.buf.dim() != 2 or hits.buf.shape[0] != 6 \
            or not hits.buf.is_contiguous():
        raise InvalidArgumentError("the hit buffer must be a contiguous [6, capacity] int32")
    if hits.count.dtype != torch.int64 or hits.count.numel() != 1:
        raise InvalidArgumentError("the hit count must be one int64")
    if not 0 < shape[0] * shape[1] <= _MAX_PAIRS:
        raise InvalidArgumentError(f"cannot emit a {tuple(shape)} counter block")


def _counter_block(counts: KingCounts) -> torch.Tensor:
    """The six counters as one contiguous [6, ni, nj] tensor: the count
    kernel's own output when the six are its consecutive planes (no copy),
    else a stacked copy (the plain count paths on a card)."""
    first = counts.both_het
    storage = first.untyped_storage().data_ptr()
    plane = first.numel() * first.element_size()
    if all(c.is_contiguous() and c.untyped_storage().data_ptr() == storage
           and c.data_ptr() == first.data_ptr() + k * plane
           for k, c in enumerate(counts)):
        return torch.as_strided(first, (6, *first.shape), (first.numel(), first.shape[1], 1))
    return torch.stack(counts)


def emit_hits(
    counts: KingCounts, hits: HitBuffer, gi_base: int, gj_base: int,
    i_limit: int, j_limit: int, threshold: float, strict: bool, sym: bool,
) -> None:
    """Appends the hits of one counter block to ``hits`` (see the module
    docstring): the emit kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    global emit_launches
    _check(counts, hits)
    device = counts.both_het.device
    if device.type == "cpu":
        emit_hits_plain(counts, hits, gi_base, gj_base, i_limit, j_limit,
                        threshold, strict, sym)
        return
    if device.type != "cuda":
        raise InvalidArgumentError(
            f"the emit kernel runs on CUDA (or its plain version on the CPU); "
            f"got device {device}"
        )
    block = _counter_block(counts)
    ni, nj = block.shape[1:]
    lib = king_cuda.library()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(lib, king_cuda.EMIT_ENTRY)(
            block.data_ptr(), ni, nj, int(gi_base), int(gj_base), int(i_limit),
            int(j_limit), float(np.float32(threshold)), int(bool(strict)),
            int(bool(sym)), hits.buf.data_ptr(), hits.capacity,
            hits.count.data_ptr(), stream,
        )
    if err:
        raise UnknownError(f"{king_cuda.EMIT_ENTRY} failed: CUDA error {err}")
    emit_launches += 1
