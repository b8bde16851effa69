"""Port of ``cuking_tpu/models/king.py``: KingEngine, all-pairs KING over
packed planes for one shard, in PyTorch.

* The pair matrix is swept in fixed-size **sample panels** (default 1024):
  for every (i-panel, j-panel) pair of the shard with any candidate i < j,
  one step runs the count kernel and the emit step (ops/king_emit.py: the
  fp32 epilogue, the mask ``valid & i < j & kin > threshold`` and the
  compaction, one CUDA kernel on a card).
* The planes are uploaded once, as an int32 view of the uint32 words, and
  the count kernel reads each panel in place through row offsets (the
  indexed entry); a diagonal panel pair sets ``tri`` so the CUDA kernel skips
  tiles wholly below the diagonal.
* Sample storage follows the reference's shard layout: the Submatrix i-range
  stored before the j-range (cuking.cu:171-175), each padded to a panel
  multiple with all-missing samples.
* Results: hits go into ONE fixed-capacity device buffer whose int64 count
  stays exact past capacity (ops/compaction.py), the JAX sweep's result
  model.  The ``max_results`` check lags as the JAX engine's does: every
  ``LIMIT_CHECK_STEPS`` steps a non-blocking copy of the count starts, and
  once more than ``LIMIT_CHECK_WINDOW`` copies are pending the loop waits
  for the oldest and raises ResourceExhausted (cuking.cu:747-751) when it
  exceeds the limit.  While the host waits, the device still has that many
  blocks of steps queued behind the copy, so it never idles on the wait,
  and an overflowing sweep stops queuing within ``LIMIT_CHECK_WINDOW + 1``
  blocks.  After the sweep the count is read once; a total in
  (capacity, max_results] re-runs the sweep once at the next power of two,
  as the JAX engine does.  The host fetches the buffer in one copy and
  sorts by (i, j, kin) (cuking.cu:761-765), which also undoes the atomic
  slot order.

Spans (``utils/stopwatch.py``, recorded while a ``torch.profiler`` records):
``engine.run`` around ``run()``; inside it ``engine.upload`` (when
``planes_dev`` uploads; ``bytes``), ``engine.schedule`` (``steps``),
``engine.steps`` (the step loop, first launch to last; ``steps``), an
``engine.limit_wait`` per wait for a count copy, ``engine.count_read``
(``total``), ``engine.fetch`` (``rows``) and ``engine.sort``.

Kernels (``KingConfig.kernel``): ``cuda`` (the hand-written count kernel,
ops/king_cuda.py), ``matmul`` (the plain PyTorch int8 product,
ops/king_mm.py), ``popcount`` (the plain AND + popcount path,
ops/king_popcount.py, on any device) or ``auto`` (``cuda`` on a CUDA device,
``matmul`` on the CPU).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable

import numpy as np
import torch

from cuking_tpu_torch.ops import bitset
from cuking_tpu_torch.ops.bitset import PlaneLayout
from cuking_tpu_torch.ops.compaction import HitBuffer, ceil_pow2
from cuking_tpu_torch.ops.king_cuda import panel_counts_cuda, panel_counts_cuda_indexed
from cuking_tpu_torch.ops.king_emit import emit_hits
from cuking_tpu_torch.ops.king_math import KingCounts
from cuking_tpu_torch.ops.king_mm import panel_counts_matmul
from cuking_tpu_torch.ops.king_popcount import panel_counts_popcount
from cuking_tpu_torch.parallel.submatrix import Submatrix
from cuking_tpu_torch.utils.status import InvalidArgumentError, ResourceExhaustedError
from cuking_tpu_torch.utils.stopwatch import StageLogger, span

DEFAULT_KIN_THRESHOLD = 0.0884  # 2nd degree or closer (cuking.cu:43-45)
DEFAULT_MAX_RESULTS = 10 << 20  # cuking.cu:40-41
# Initial device result-buffer slots (24 B each): smaller than max_results
# so a hit-light sweep doesn't allocate the reference's full 252 MiB.
DEFAULT_RESULT_CAPACITY = 1 << 20
KERNELS = ("auto", "cuda", "matmul", "popcount")
# Steps between the sweep's non-blocking copies of its hit count (the JAX
# sweep checks max_results once per 64-step dispatch), and the copies that
# may be pending before the sweep waits for the oldest (the JAX engine's
# ``window`` of dispatches).
LIMIT_CHECK_STEPS = 64
LIMIT_CHECK_WINDOW = 4


def _ceil_div(a: int, b: int) -> int:
    return (a + b - 1) // b


@dataclass(frozen=True)
class KingConfig:
    """Runtime knobs; defaults mirror the reference's flags (cuking.cu:27-52)."""

    kin_threshold: float = DEFAULT_KIN_THRESHOLD
    max_results: int = DEFAULT_MAX_RESULTS
    panel: int = 1024               # samples per panel (pair tile edge)
    kernel: str = "auto"            # auto | cuda | matmul | popcount
    site_chunk_words: int = 128     # words per site chunk, matmul kernel only
    popcount_row_block: int = 8     # i-rows per popcount block
    result_capacity: int = 0        # initial result-buffer slots (0 = auto)
    device: str = "cuda"
    verbose: bool = False

    def resolved_result_capacity(self) -> int:
        """Initial device result-buffer capacity: the explicit knob, else
        min(max_results, DEFAULT_RESULT_CAPACITY)."""
        return self.result_capacity or max(
            1, min(self.max_results, DEFAULT_RESULT_CAPACITY)
        )


def resolve_kernel_name(config: KingConfig) -> str:
    """'auto' → 'cuda' on a CUDA device, 'matmul' elsewhere; 'cuda' on a
    non-CUDA device is an InvalidArgument."""
    if config.kernel not in KERNELS:
        raise InvalidArgumentError(f"Unknown kernel: {config.kernel}")
    device_type = torch.device(config.device).type
    if config.kernel == "auto":
        return "cuda" if device_type == "cuda" else "matmul"
    if config.kernel == "cuda" and device_type != "cuda":
        raise InvalidArgumentError(
            f"The cuda kernel needs a CUDA device, not {config.device}"
        )
    return config.kernel


def resolve_kernel(config: KingConfig) -> Callable:
    """The sliced count entry ``(planes_i, planes_j, tri) -> KingCounts`` of
    the configured kernel (the ring's sub-tile kernel)."""
    name = resolve_kernel_name(config)
    if name == "cuda":
        return panel_counts_cuda
    if name == "popcount":
        return partial(panel_counts_popcount, row_block=config.popcount_row_block)

    def matmul(planes_i, planes_j, tri=None):
        return panel_counts_matmul(
            planes_i, planes_j, site_chunk_words=config.site_chunk_words
        )

    return matmul


def resolve_indexed_kernel(config: KingConfig) -> Callable | None:
    """The indexed entry (row offsets into full storage, no panel copies)
    when the CUDA kernel is selected; None otherwise."""
    return panel_counts_cuda_indexed if resolve_kernel_name(config) == "cuda" else None


@dataclass
class ResultSet:
    """Thresholded pairs, globally indexed, sorted by (i, j, kin)."""

    i_idx: np.ndarray   # int32 global sample indices
    j_idx: np.ndarray
    kin: np.ndarray     # float32
    ibs0: np.ndarray    # int32
    ibs1: np.ndarray
    ibs2: np.ndarray

    def __len__(self) -> int:
        return len(self.i_idx)

    @classmethod
    def concat_and_sort(cls, parts: list["ResultSet"]) -> "ResultSet":
        if not parts:
            z = np.zeros(0, np.int32)
            return cls(z, z, np.zeros(0, np.float32), z.copy(), z.copy(), z.copy())
        fields = {
            name: np.concatenate([getattr(p, name) for p in parts])
            for name in ("i_idx", "j_idx", "kin", "ibs0", "ibs1", "ibs2")
        }
        # Sort by (i, j, kin) ascending, like cuking.cu:761-765.
        order = np.lexsort((fields["kin"], fields["j_idx"], fields["i_idx"]))
        return cls(**{k: v[order] for k, v in fields.items()})

    @classmethod
    def from_rows(cls, rows: np.ndarray) -> "ResultSet":
        """[6, n] int32 hit rows ``(i, j, kin bits, ibs0, ibs1, ibs2)``,
        unsorted."""
        return cls(rows[0], rows[1], rows[2].view(np.float32), rows[3], rows[4], rows[5])


class PanelStorage:
    """Padded on-host plane storage in the reference's shard layout.

    The Submatrix i-range is stored first, then (for off-diagonal shards) the
    j-range (cuking.cu:171-175); each section is padded up to a panel multiple
    with all-missing samples so every panel has the same shape.
    """

    def __init__(self, layout: PlaneLayout, submatrix: Submatrix, panel: int):
        self.layout = layout
        self.submatrix = submatrix
        self.panel = panel
        # Bumped by mutators (ingest); lets device-side caches detect stale
        # uploads instead of silently computing on pre-ingest planes.
        self.version = 0
        self.nr = submatrix.num_rows
        self.nc = submatrix.num_cols
        self.nr_pad = max(_ceil_div(self.nr, panel), 1) * panel
        if submatrix.is_diagonal:
            self.nc_pad = self.nr_pad
            self.j_store_base = 0
            total = self.nr_pad
        else:
            self.nc_pad = max(_ceil_div(self.nc, panel), 1) * panel
            self.j_store_base = self.nr_pad
            total = self.nr_pad + self.nc_pad
        self.planes = bitset.allocate_planes(total, layout)

    def mark_mutated(self) -> None:
        """Callers that write into ``planes`` (ingest) record it here so the
        engine re-uploads instead of sweeping a stale device copy."""
        self.version += 1

    def contains(self, global_idx: np.ndarray) -> np.ndarray:
        """True for samples stored in this shard (cuking.cu:675-678)."""
        return self.submatrix.contains(global_idx)

    def storage_offsets(self, global_idx: np.ndarray) -> np.ndarray:
        """Global sample index → padded storage row; callers must only pass
        indices with ``contains(idx)`` true (cf. cuking.cu:675-678).
        Branch-free arithmetic rather than np.where: this runs over
        ~10⁷-element index arrays per Parquet file at gnomAD ingest scale."""
        sm = self.submatrix
        global_idx = np.asarray(global_idx)
        in_j = (global_idx >= sm.i_end).astype(global_idx.dtype)
        return (
            global_idx
            - sm.i_begin
            + in_j * (self.j_store_base - sm.j_begin + sm.i_begin)
        )

    @property
    def num_i_panels(self) -> int:
        return self.nr_pad // self.panel

    @property
    def num_j_panels(self) -> int:
        return self.nc_pad // self.panel

    def i_panel(self, k: int) -> tuple[int, int, int]:
        """→ (storage offset, global base index, valid sample count)."""
        off = k * self.panel
        return off, self.submatrix.i_begin + off, max(0, min(self.panel, self.nr - off))

    def j_panel(self, k: int) -> tuple[int, int, int]:
        off = k * self.panel
        return (
            self.j_store_base + off,
            self.submatrix.j_begin + off,
            max(0, min(self.panel, self.nc - off)),
        )


class KingEngine:
    """Single-process KING engine for one shard (whole matrix if
    split_factor=1) on ``config.device``."""

    def __init__(
        self,
        storage: PanelStorage,
        config: KingConfig | None = None,
        logger: StageLogger | None = None,
    ):
        self.config = config or KingConfig()
        self.storage = storage
        self.logger = logger or StageLogger(enabled=self.config.verbose)
        self.device = torch.device(self.config.device)
        self.kernel_name = resolve_kernel_name(self.config)
        self._kernel = resolve_kernel(self.config)
        self._indexed_kernel = resolve_indexed_kernel(self.config)
        self._planes_dev_cache = None
        self._planes_dev_version = None

    @property
    def planes_dev(self) -> torch.Tensor:
        """Device-resident int32 view of the planes; uploaded once per
        storage version (ingest bumps it through ``mark_mutated``; direct
        writes to ``storage.planes`` need ``refresh_planes()``)."""
        version = self.storage.version
        if self._planes_dev_cache is None or self._planes_dev_version != version:
            self._planes_dev_cache = None  # free the old copy before uploading
            host = torch.from_numpy(self.storage.planes.view(np.int32))
            with span("engine.upload", bytes=host.nbytes):
                self._planes_dev_cache = host.to(self.device)
            self._planes_dev_version = version
        return self._planes_dev_cache

    def refresh_planes(self) -> None:
        self._planes_dev_cache = None

    @classmethod
    def from_genotypes(
        cls,
        genotypes: np.ndarray,
        config: KingConfig | None = None,
        submatrix: Submatrix | None = None,
        words_multiple: int = bitset.DEFAULT_WORDS_MULTIPLE,
    ) -> "KingEngine":
        """Test/synthetic convenience: dense [N, S] genotypes → engine."""
        config = config or KingConfig()
        n, s = genotypes.shape
        submatrix = submatrix or Submatrix.create(n, 1, 0)
        layout = PlaneLayout.create(s, words_multiple=words_multiple)
        storage = PanelStorage(layout, submatrix, config.panel)
        stored = submatrix.stored_sample_indices()
        offsets = storage.storage_offsets(stored)
        storage.planes[:, offsets, :] = bitset.pack_genotypes(
            genotypes[stored], layout
        )
        return cls(storage, config)

    def _panel_pair_params(self) -> np.ndarray:
        """[num_steps, 6] int32 schedule: (i_off, j_off, gi_base, gj_base,
        ni_valid, nj_valid) for every (i-panel, j-panel) pair with any
        candidate i<j, mirroring the shard's pair set (cuking.cu:196-201)."""
        st = self.storage
        diagonal = st.submatrix.is_diagonal
        rows = []
        for ip in range(st.num_i_panels):
            i_off, gi_base, ni_valid = st.i_panel(ip)
            if ni_valid == 0:
                continue
            jp_start = ip if diagonal else 0
            for jp in range(jp_start, st.num_j_panels):
                j_off, gj_base, nj_valid = st.j_panel(jp)
                if nj_valid == 0:
                    continue
                rows.append((i_off, j_off, gi_base, gj_base, ni_valid, nj_valid))
        return np.asarray(rows, dtype=np.int32).reshape(-1, 6)

    def _counts(self, planes: torch.Tensor, i_off: int, j_off: int,
                tri: bool) -> KingCounts:
        panel = self.config.panel
        if self._indexed_kernel is not None:
            return self._indexed_kernel(planes, i_off, j_off, tri, panel)
        return self._kernel(
            planes[:, i_off : i_off + panel], planes[:, j_off : j_off + panel], tri
        )

    def run(self) -> ResultSet:
        """Sweeps all (i-panel, j-panel) pairs of the shard and returns the
        thresholded, sorted results."""
        with span("engine.run") as run_span:
            cfg = self.config
            st = self.storage
            capacity = cfg.resolved_result_capacity()
            sweeps = 0
            while True:
                self.logger.begin(
                    f"Running KING kernel for {st.nr} x {st.nc} matrix"
                    f" ({len(self._panel_pair_params())} panel-pair steps)...",
                    "king_kernel",
                )
                hits = self.sweep(capacity)
                sweeps += 1
                run_span.count(sweeps=sweeps)
                with span("engine.count_read") as read:
                    total = int(hits.count)  # the sweep's one read of the device
                    read.count(total=total)
                self.logger.end()
                _check_max_results(total, cfg.max_results)
                if total <= capacity:
                    break
                # Exact total in (capacity, max_results]: re-run once at the
                # next pow2 bucket, as the JAX engine does.
                new_capacity = min(ceil_pow2(total), cfg.max_results)
                self.logger.print(
                    f"Result buffer overflowed ({total} hits > {capacity} "
                    f"slots); re-running at capacity {new_capacity}."
                )
                capacity = new_capacity
                del hits  # free the full buffer before the next one is made

            self.logger.print(f"Processing {total} results...")
            parts = []
            if total:
                with span("engine.fetch", rows=total):
                    parts.append(ResultSet.from_rows(hits.rows(total)))
            with span("engine.sort"):
                return ResultSet.concat_and_sort(parts)

    def sweep(self, capacity: int) -> HitBuffer:
        """Runs every panel-pair step into a fresh :class:`HitBuffer` of
        ``capacity`` slots and returns it.  A step is one count launch and
        one emit launch.  Every ``LIMIT_CHECK_STEPS`` steps a copy of the
        count starts; once more than ``LIMIT_CHECK_WINDOW`` copies are
        pending, the loop waits for the oldest (the only wait for the device
        here; the caller reads the final ``count``) and raises
        ResourceExhausted when it exceeds ``max_results``."""
        cfg = self.config
        planes = self.planes_dev
        hits = HitBuffer(capacity, self.device)
        with span("engine.schedule") as schedule:
            params = self._panel_pair_params().tolist()
            schedule.count(steps=len(params))
        # The loop's spans take the tracing decision from this one: no
        # per-step span, and no flag read inside the loop.
        with span("engine.steps", steps=len(params)) as steps:
            for step, (i_off, j_off, gi_base, gj_base, ni, nj) in enumerate(params, 1):
                # A diagonal panel pair (same global base) lets the CUDA kernel
                # skip lower-triangle tiles; the strict i<j mask never reads them.
                counts = self._counts(planes, i_off, j_off, gi_base == gj_base)
                emit_hits(counts, hits, gi_base, gj_base, gi_base + ni, gj_base + nj,
                          cfg.kin_threshold, strict=True, sym=False)
                if step % LIMIT_CHECK_STEPS == 0:
                    hits.snapshot()
                    if hits.pending > LIMIT_CHECK_WINDOW:
                        with span("engine.limit_wait", steps):
                            count = hits.wait_oldest()
                        _check_max_results(count, cfg.max_results)
        return hits


def _check_max_results(count: int, max_results: int) -> None:
    if count > max_results:
        raise ResourceExhaustedError(
            "Could not store all results: try increasing the "
            "--max_results parameter."
        )
