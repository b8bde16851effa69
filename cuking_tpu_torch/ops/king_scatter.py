"""Ingest's scatter into bit planes that live on the card: each file's kept
COO entries, checked on the host, packed into 8-byte records, staged
through a fixed pool of pinned buffers and cleared into the planes by the
scatter kernel (``csrc/king_scatter.cu``).

The JAX package and the port's host paths scatter into numpy planes on the
host (``ops/bitset.clear_bits_coo``, ``native/packer.clear_bits``) and the
engine uploads them.  With planes on the card (``PanelStorage(device=...)``,
which the CLI builds for one engine on a CUDA device) the host allocates no
planes and uploads none.

* :func:`check_entries` — the host's checks of a file's kept entries, as the
  host paths make them: ``n_alt`` in 0..2 and every site in
  ``[0, num_sites)``, by min/max reductions, before any record is sent.
* :func:`pack_records` — entries → records: a ``[2, n]`` int32 block, the
  storage rows, then ``site << 2 | n_alt`` (read as uint32).
* :func:`scatter_records` — the kernel on a CUDA tensor, launched on the
  current stream; on a CPU tensor its plain version,
  :func:`scatter_records_plain`.  ``launches`` counts the kernel's launches.
* :class:`Stager` — ingest's staging: ``utils/hbm.STAGING_BYTES`` of device
  memory in ``STAGING_SLOTS`` slots, each with its pinned host twin and an
  event, and one side stream that copies each slot's records and launches
  the kernel on them.  A file larger than a slot goes in several chunks.  A
  slot's buffers are written again only after the event of its last launch
  has completed; :meth:`Stager.close` makes the current stream wait on the
  side stream and synchronises it, so a fault in a scatter surfaces there.
  Its CPU mode (one slot, no stream, the plain version) serves the CPU
  tests alone, which reach the chunking and the check-before-send order
  through it: the CLI on a CPU device keeps numpy planes.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch

from cuking_tpu_torch.ops import king_cuda
from cuking_tpu_torch.ops.bitset import HOM, HET, PlaneLayout
from cuking_tpu_torch.utils.hbm import STAGING_BYTES
from cuking_tpu_torch.utils.status import (
    FailedPreconditionError,
    InvalidArgumentError,
    UnknownError,
)

# The staging pool's slots (STAGING_BYTES in all): one per decode thread of
# an H100 machine's 8 CPUs, so a thread rarely waits for one.
STAGING_SLOTS = 8
RECORD_BYTES = 8
# A record keeps the site in 30 bits.
MAX_SITES = 1 << 30

# Kernel launches since import (or since a caller reset them to 0); several
# decode threads launch, so the count is kept under a lock.
launches = 0
_launches_lock = threading.Lock()


def check_entries(layout: PlaneLayout, sites: np.ndarray, n_alt: np.ndarray,
                  source: str) -> None:
    """Raises FailedPreconditionError naming ``source`` and the value when an
    ``n_alt`` lies outside 0..2 or a site outside ``[0, num_sites)``."""
    if not len(n_alt):
        return
    lo, hi = int(n_alt.min()), int(n_alt.max())
    if lo < 0 or hi > 2:
        raise FailedPreconditionError(
            f"Invalid value for n_alt_alleles ({lo if lo < 0 else hi}) "
            f"encountered in {source}"
        )
    lo, hi = int(sites.min()), int(sites.max())
    if lo < 0 or hi >= layout.num_sites:
        raise FailedPreconditionError(
            f"Site index {lo if lo < 0 else hi} out of range "
            f"[0, {layout.num_sites}) in {source}"
        )


def pack_records(out: np.ndarray, rows: np.ndarray, sites: np.ndarray,
                 n_alt: np.ndarray) -> None:
    """Writes checked entries into ``out``, a ``[2, n]`` int32 array: the
    storage rows, then ``site << 2 | n_alt``."""
    np.copyto(out[0], rows, casting="unsafe")
    # Narrowed first, then shifted in place: a shift that casts as it writes
    # takes longer than the two passes.
    np.copyto(out[1], sites, casting="unsafe")
    np.left_shift(out[1], 2, out=out[1])
    np.bitwise_or(out[1], n_alt, out=out[1], casting="unsafe")


def scatter_records_plain(planes: torch.Tensor, records: torch.Tensor) -> None:
    """The kernel's plain version: clears the records' bits in ``planes``
    ([2, rows, W] int32) in place.  The (word, bit) pairs of each plane are
    made unique first, so a word's clear mask is the sum of its distinct
    bits."""
    words = planes.shape[2]
    rows, codes = records[0].long(), records[1]
    # The code is a uint32: a site of 2**29 or more sets its top bit.
    site, n_alt = (codes.long() & 0xFFFFFFFF) >> 2, codes & 3
    lin = rows * words + site % words
    bit = site // words
    flat = planes.view(2, -1)
    for plane, sel in ((HET, n_alt != 1), (HOM, n_alt != 2)):
        keys = torch.unique(lin[sel] * 32 + bit[sel])
        touched, which = torch.unique_consecutive(keys >> 5, return_inverse=True)
        masks = torch.zeros(len(touched), dtype=torch.int64, device=planes.device)
        masks.index_add_(0, which, torch.ones_like(keys) << (keys & 31))
        # The low 32 bits of ~mask, as int32.
        flat[plane, touched] &= (~masks & 0xFFFFFFFF).to(torch.int32)


def scatter_records(planes: torch.Tensor, records: torch.Tensor) -> None:
    """Clears the bits of ``records`` ([2, n] int32, checked on the host)
    in ``planes`` ([2, rows, W] int32, contiguous): the kernel on a CUDA
    tensor, on the current stream; the plain version on a CPU tensor."""
    global launches
    if planes.dim() != 3 or planes.shape[0] != 2 or planes.dtype != torch.int32 \
            or not planes.is_contiguous():
        raise InvalidArgumentError("planes must be a contiguous [2, rows, W] int32 tensor")
    if records.dim() != 2 or records.shape[0] != 2 or records.dtype != torch.int32 \
            or not records.is_contiguous():
        raise InvalidArgumentError("records must be a contiguous [2, n] int32 tensor")
    if records.device != planes.device:
        raise InvalidArgumentError(
            f"records on {records.device}, planes on {planes.device}")
    n = records.shape[1]
    if n == 0:
        return
    if planes.device.type == "cpu":
        scatter_records_plain(planes, records)
        return
    if planes.device.type != "cuda":
        raise InvalidArgumentError(
            f"the scatter kernel runs on CUDA (or its plain version on the CPU); "
            f"got device {planes.device}"
        )
    lib = king_cuda.library()
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    with torch.cuda.device(planes.device):
        err = getattr(lib, king_cuda.SCATTER_ENTRY)(
            records.data_ptr(), n, planes.data_ptr(), planes.shape[1], planes.shape[2],
            stream,
        )
    if err:
        raise UnknownError(f"{king_cuda.SCATTER_ENTRY} failed: CUDA error {err}")
    with _launches_lock:
        launches += 1


@dataclass
class _Slot:
    host: torch.Tensor                   # pinned on a card; the records packed here
    dev: torch.Tensor | None             # the card's copy (None on CPU planes)
    event: torch.cuda.Event | None       # recorded after the slot's last launch


class Stager:
    """Ingest's staging of records into ``planes`` (see the module
    docstring).  :meth:`send` may be called from several threads at once;
    :meth:`close` once, after every send has returned."""

    def __init__(self, planes: torch.Tensor, layout: PlaneLayout):
        if layout.num_sites > MAX_SITES:
            raise FailedPreconditionError(
                f"{layout.num_sites} sites do not fit a scatter record's "
                f"{MAX_SITES.bit_length() - 1} bits")
        self.planes, self.layout = planes, layout
        self.cuda = planes.device.type == "cuda"
        slots = STAGING_SLOTS if self.cuda else 1
        self.slot_records = STAGING_BYTES // (slots * RECORD_BYTES)
        size = slots * 2 * self.slot_records
        self._slots: list[_Slot] = []
        self._free: queue.SimpleQueue = queue.SimpleQueue()
        self.stream = None
        if self.cuda:
            king_cuda.library()  # built here, not by the first of many threads
            host = torch.empty(size, dtype=torch.int32, pin_memory=True)
            dev = torch.empty(size, dtype=torch.int32, device=planes.device)
            self.stream = torch.cuda.Stream(planes.device)
            # The planes' fill comes first.
            self.stream.wait_stream(torch.cuda.current_stream(planes.device))
        else:
            host, dev = torch.empty(size, dtype=torch.int32), None
        for k in range(slots):
            part = slice(k * 2 * self.slot_records, (k + 1) * 2 * self.slot_records)
            slot = _Slot(host[part], None, None)
            if self.cuda:
                slot.dev, slot.event = dev[part], torch.cuda.Event()
            self._slots.append(slot)
            self._free.put(slot)

    def send(self, rows: np.ndarray, sites: np.ndarray, n_alt: np.ndarray,
             source: str) -> None:
        """Checks one file's kept entries (:func:`check_entries`), then
        clears their bits in the planes, ``slot_records`` at a time."""
        check_entries(self.layout, sites, n_alt, source)
        for lo in range(0, len(n_alt), self.slot_records):
            hi = min(lo + self.slot_records, len(n_alt))
            slot = self._free.get()
            try:
                self._send_chunk(slot, rows[lo:hi], sites[lo:hi], n_alt[lo:hi])
            finally:
                self._free.put(slot)

    def _send_chunk(self, slot: _Slot, rows, sites, n_alt) -> None:
        n = len(n_alt)
        if self.cuda:
            slot.event.synchronize()  # the slot's last copy and launch are done
        host = slot.host[:2 * n]
        pack_records(host.numpy().reshape(2, n), rows, sites, n_alt)
        if not self.cuda:
            scatter_records(self.planes, host.view(2, n))
            return
        with torch.cuda.stream(self.stream):
            dev = slot.dev[:2 * n]
            dev.copy_(host, non_blocking=True)
            scatter_records(self.planes, dev.view(2, n))
            slot.event.record(self.stream)

    def close(self) -> None:
        """Makes the current stream wait on the side stream and waits for
        it, so no sweep reads planes still being written and a fault in a
        scatter raises here; then frees the pool."""
        if self.cuda:
            torch.cuda.current_stream(self.planes.device).wait_stream(self.stream)
            try:
                self.stream.synchronize()
            except RuntimeError as e:  # a fault during a scatter, reported here
                raise UnknownError(f"the scatter kernel failed: {e}") from e
        self._slots = []
        self._free = queue.SimpleQueue()
