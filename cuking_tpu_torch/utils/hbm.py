"""Port of ``cuking_tpu/utils/hbm.py``: fail before a device out-of-memory
error, with a fix in hand.

The reference sizes its allocations against a known GPU memory envelope and
prescribes ``--split_factor`` as the memory-relief mechanism
(cuking.cu:513-517; README.md:96-98).  The engine's equivalent: compute the
device-resident footprint of a shard's sweep UP FRONT — bit planes, the
result buffer and the per-step transients — compare it with the device's
free memory, and when it doesn't fit, raise InvalidArgument naming the
**minimal split factor that does**.

The ring has its own model (``check_ring_fit``).  Several ring positions
may share one device, so the need of a device is the need of one position
times the positions it holds.

The limit is ``torch.cuda.mem_get_info`` on a CUDA device; a CPU device has
none and the check is skipped.  ``CUKING_HBM_BYTES_LIMIT`` overrides the
query for tests and for operators who want headroom for a colocated process.
"""

from __future__ import annotations

import os

import torch

from cuking_tpu_torch.utils.status import InvalidArgumentError

# Fraction of the free device memory the sweep may plan to use: the caching
# allocator rounds blocks up and fragments.
_USABLE_FRACTION = 0.92

# Device bytes per pair of one panel-pair step at the step's peak: the six
# int32 counters (or the matmul kernel's int32 Gram and int8 indicators), the
# float32 epilogue temporaries, the mask, and — when every pair is a hit —
# the int64 nonzero indices and the gathered hit rows.  Measured peaks at
# panel 1024 on an H100 were 109 (cuda kernel, few hits) to 253 (matmul
# kernel, all hits) bytes per pair (PERF.md); this covers the worst.
TRANSIENT_BYTES_PER_PAIR = 256


def device_bytes_limit(device) -> int | None:
    """Usable bytes on ``device``, or None when unknowable (CPU).

    Env override ``CUKING_HBM_BYTES_LIMIT`` (raw bytes) wins when set."""
    env = os.environ.get("CUKING_HBM_BYTES_LIMIT")
    if env:
        try:
            return int(env)
        except ValueError:
            raise InvalidArgumentError(
                f"CUKING_HBM_BYTES_LIMIT must be a raw byte count, got {env!r}"
            )
    device = torch.device(device)
    if device.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(device)
    return int(free * _USABLE_FRACTION)


def _ceil_to(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def plane_bytes(num_stored_rows: int, words: int, panel: int = 1) -> int:
    """Device bytes for the [2, rows, W] 32-bit bit planes, rows padded to a
    panel multiple per range (PanelStorage layout)."""
    return 2 * _ceil_to(max(num_stored_rows, 1), panel) * words * 4


def shard_plane_bytes(
    num_samples: int, split_factor: int, words: int, panel: int
) -> int:
    """Worst-shard plane footprint at a given split factor: an off-diagonal
    shard stores row range + column range, each a full-size block padded to a
    panel multiple (cuking.cu:158-175, 507-517)."""
    block = -(-num_samples // split_factor)
    if split_factor == 1:
        return plane_bytes(num_samples, words, panel)
    return plane_bytes(block, words, panel) + plane_bytes(block, words, panel)


def sweep_buffer_bytes(config) -> int:
    """Device bytes for the engine sweep beyond the planes: the [6, capacity]
    int32 result buffer at its worst capacity (max_results, the largest the
    overflow re-run can ask for; the re-run frees the full buffer first),
    plus one step's transients (``TRANSIENT_BYTES_PER_PAIR`` per pair of the
    panel)."""
    per_slot = 6 * 4  # i/j idx i32, kin f32, ibs0/1/2 i32
    worst_capacity = max(config.resolved_result_capacity(), config.max_results)
    result_buffer = worst_capacity * per_slot
    transients = TRANSIENT_BYTES_PER_PAIR * config.panel * config.panel
    return result_buffer + transients


def engine_plane_bytes(submatrix, words: int, panel: int) -> int:
    """Exact plane footprint of one shard's PanelStorage: the i-range and
    (off-diagonal) j-range are each padded to a panel multiple separately."""
    b = plane_bytes(submatrix.num_rows, words, panel)
    if not submatrix.is_diagonal:
        b += plane_bytes(submatrix.num_cols, words, panel)
    return b


def check_engine_fit(
    num_samples: int,
    words: int,
    submatrix,
    config,
    split_factor: int,
    bytes_limit: int | None = None,
) -> None:
    """Raises InvalidArgument naming the minimal --split_factor that fits
    when this shard's sweep footprint exceeds the device's memory.

    No-op when the limit is unknowable (CPU devices)."""
    limit = device_bytes_limit(config.device) if bytes_limit is None else bytes_limit
    if limit is None:
        return
    planes_b = engine_plane_bytes(submatrix, words, config.panel)
    buffers_b = sweep_buffer_bytes(config)
    need = planes_b + buffers_b
    if need <= limit:
        return

    def worst(k: int) -> int:
        return shard_plane_bytes(num_samples, k, words, config.panel) + buffers_b

    # Splitting shrinks only the plane term; the result-buffer term is
    # k-independent.  If not even maximal splitting fits, say so instead of
    # prescribing a split factor that cannot work.
    if worst(num_samples) > limit:
        raise InvalidArgumentError(
            f"Shard needs {need >> 20} MiB of device memory but only "
            f"{limit >> 20} MiB is available, and no --split_factor can "
            f"relieve it: the {buffers_b >> 20} MiB worst-case result "
            "buffers alone don't fit. Lower --max_results/"
            "--result_capacity, or use a device with more memory."
        )
    lo, hi = split_factor, num_samples  # worst(hi) <= limit
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if worst(mid) > limit:
            lo = mid
        else:
            hi = mid
    raise InvalidArgumentError(
        f"Shard needs {need >> 20} MiB of device memory "
        f"({planes_b >> 20} MiB bit planes + "
        f"{buffers_b >> 20} MiB sweep buffers) but only "
        f"{limit >> 20} MiB is available; increase --split_factor to at "
        f"least {hi}."
    )


def ring_rows_per_device(
    rows: int, panel: int, row_multiple: int, num_devices: int
) -> int:
    """Per-position row count the ring will actually use for a range of
    ``rows`` samples: panel-padded storage rows (PanelStorage layout) split
    over the ring, rounded to the kernel's row multiple — mirroring
    all_pairs_sharded/rect_pairs_sharded padding exactly."""
    padded = _ceil_to(max(rows, 1), panel)
    nd = -(-padded // num_devices)
    return _ceil_to(nd, row_multiple)


def _ring_hits_bytes(capacity_per_device: int, max_results: int | None) -> int:
    """Worst-case hit-buffer bytes per position: the overflow auto-retry
    (parallel/ring._run_with_retry) can regrow the buffer to a pow2 bucket
    capped at the GLOBAL max_results, so the up-front check budgets that
    ceiling (the engine model worst-cases the same way).  One set is enough:
    the retry frees the first run's buffers before it allocates its own, as
    the engine's re-run does (``sweep_buffer_bytes``)."""
    worst = capacity_per_device
    if max_results is not None:
        worst = max(worst, max_results)
    return 6 * 4 * worst


def ring_shard_bytes(
    num_rows: int,
    num_cols: int,
    is_diagonal: bool,
    words: int,
    panel: int,
    row_multiple: int,
    num_devices: int,
    capacity_per_device: int,
    max_results: int | None = None,
    positions_per_device: int = 1,
) -> int:
    """Device bytes for one Submatrix shard's ring sweep.  Per position, a
    diagonal shard holds 3 copies of its row block (resident + visiting +
    one in flight); an off-diagonal shard holds its resident i-block plus 2
    rotating j-blocks; both add the six hit buffers at their worst
    (post-retry) capacity.  A device holding several positions needs that
    many times the per-position bytes."""
    hits_b = _ring_hits_bytes(capacity_per_device, max_results)
    nd_i = ring_rows_per_device(num_rows, panel, row_multiple, num_devices)
    panel_i = 2 * nd_i * words * 4
    if is_diagonal:
        per_position = 3 * panel_i + hits_b
    else:
        nd_j = ring_rows_per_device(num_cols, panel, row_multiple, num_devices)
        per_position = panel_i + 2 * (2 * nd_j * words * 4) + hits_b
    return positions_per_device * per_position


def _worst_ring_shard_bytes(
    num_samples: int, split_factor: int, words: int, panel: int,
    row_multiple: int, num_devices: int, capacity_per_device: int,
    max_results: int | None = None, positions_per_device: int = 1,
) -> int:
    """Worst shard at a given split factor: for k ≥ 2 an off-diagonal shard
    holding two full-size blocks (cuking.cu:158-175); for k = 1 the single
    diagonal shard."""
    block = -(-num_samples // split_factor)
    return ring_shard_bytes(
        block, block, split_factor == 1, words, panel, row_multiple,
        num_devices, capacity_per_device, max_results, positions_per_device,
    )


def check_ring_fit(
    num_samples: int,
    words: int,
    rows_per_device: int,
    capacity_per_device: int,
    num_devices: int,
    bytes_limit: int | None = None,
    *,
    submatrix=None,
    panel: int = 1,
    row_multiple: int = 1,
    split_factor: int = 1,
    max_results: int | None = None,
    positions_per_device: int = 1,
) -> None:
    """Ring capacity check.  When this shard's ring footprint exceeds the
    device memory, raises InvalidArgument naming the minimal
    ``--split_factor`` whose worst shard fits on this ring — --use_mesh
    composes with --split_factor (parallel/ring.submatrix_pairs_sharded),
    so sharding is the memory relief here as on the engine path
    (README.md:94-102).  Hit buffers are budgeted once per position, at
    their worst post-auto-retry capacity (the larger of the capacity and
    ``max_results`` when given): the retry frees the first run's buffers
    first.

    ``num_devices`` counts ring positions; ``positions_per_device`` is the
    most positions any one device holds.  ``submatrix`` enables the
    per-shard model (what the CLI passes); without it, ``rows_per_device``
    drives the plain triangular-ring model.  ``bytes_limit`` is the
    smallest :func:`device_bytes_limit` of the ring's devices; None (CPU
    positions) skips the check."""
    if bytes_limit is None:
        return
    limit = bytes_limit
    hits_b = _ring_hits_bytes(capacity_per_device, max_results)
    if submatrix is not None:
        need = ring_shard_bytes(
            submatrix.num_rows, submatrix.num_cols, submatrix.is_diagonal,
            words, panel, row_multiple, num_devices, capacity_per_device,
            max_results, positions_per_device,
        )
    else:
        need = positions_per_device * (3 * (2 * rows_per_device * words * 4) + hits_b)
    if need <= limit:
        return

    def worst(k: int) -> int:
        return _worst_ring_shard_bytes(
            num_samples, k, words, panel, row_multiple, num_devices,
            capacity_per_device, max_results, positions_per_device,
        )

    # Splitting shrinks only the plane term; the hit-buffer term is
    # k-independent.  If not even maximal splitting fits, say so instead of
    # prescribing a split factor that cannot work.
    if worst(num_samples) > limit:
        raise InvalidArgumentError(
            f"Each of the {num_devices} mesh devices needs {need >> 20} MiB "
            f"for this shard's ring sweep but only {limit >> 20} MiB is "
            f"available, and no --split_factor can relieve it: the "
            f"{hits_b >> 20} MiB worst-case hit buffers alone don't fit. "
            "Lower --max_results/--capacity_per_device, or run on a larger "
            "slice."
        )
    if worst(split_factor) <= limit:
        # The caller's `need` (e.g. a library-supplied rows_per_device with
        # padding beyond this model) exceeds the limit although the
        # worst-shard model at the current split fits: a split prescription
        # would be misleading, so give none.
        raise InvalidArgumentError(
            f"Each of the {num_devices} mesh devices needs {need >> 20} MiB "
            f"for this ring sweep (incl. {hits_b >> 20} MiB worst-case hit "
            f"buffers) but only {limit >> 20} MiB is available; reduce the "
            "per-device row count or run on a larger slice."
        )
    # worst(k) is non-increasing in k: binary-search the minimal fitting k.
    lo, hi = split_factor, num_samples  # worst(lo) > limit, worst(hi) <= limit
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if worst(mid) > limit:
            lo = mid
        else:
            hi = mid
    raise InvalidArgumentError(
        f"Each of the {num_devices} mesh devices needs {need >> 20} MiB "
        f"for this shard's ring sweep (incl. {hits_b >> 20} MiB worst-case "
        f"hit buffers) but only {limit >> 20} MiB is available; increase "
        f"--split_factor to at least {hi} (it composes with --use_mesh), "
        "or run on a larger slice."
    )
