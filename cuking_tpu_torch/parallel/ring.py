"""Port of ``cuking_tpu/parallel/ring.py``: all-pairs KING over a ring of
sample row blocks.

The reference spreads a cohort over GPUs with share-nothing jobs, one per
GPU (SURVEY.md §1).  The ring instead shards the cohort's sample rows over
``D`` ring positions and rotates the j-blocks around the ring, so every
block pair of the global matrix is covered once.

Balanced triangular schedule (``ring_schedule`` is its executable
specification; see the TPU package for the derivation): rotating blocks
*backwards* (position d receives from d+1) puts block ``(d + t) mod D`` on
position d at step t, so

    step 0:             every position × its own block   (diagonal, tri)
    steps 1..⌊(D-1)/2⌋: every position × block (d+t)     (distinct pairs)
    step D/2 (D even):  positions d and d+D/2 both hold pair {d, d+D/2}
                        and each computes HALF of it

covers each of the D(D+1)/2 block pairs exactly once, with the same work on
every position.  Off-diagonal Submatrix shards take the rectangular ring:
the i-block stays resident, the j-block rotates for D steps.

What replaces the TPU package's machinery:

* ``jax.sharding.Mesh`` becomes :class:`RingMesh`: the ring positions in
  mesh order, the torch device of each, the process (rank) that owns each.
  On a multi-GPU host the positions are ``cuda:0 … cuda:k-1``; several
  positions may share one device (``cuda:0`` repeated on a one-card machine,
  ``cpu`` repeated in the tests).
* ``shard_map`` + ``lax.ppermute`` become an eager lockstep loop over the
  local positions with the JAX ring's schedule: rotation t+1 is started
  before step t's first sub-tile is queued (the first one before step 0's
  triangle), and finished just before step t+1's first sub-tile, so the
  transfer can run under step t's kernels.  At most one rotation is in
  flight, so a position holds its resident block, the visitor being read
  and the visitor in flight: the three blocks ``utils/hbm.ring_shard_bytes``
  budgets.  A rotation (:func:`_start_rotation`, :func:`_finish_rotation`)
  moves each block by one of three transports:

  - positions on one device: the tensor itself is handed on, with no copy
    and no stream, so a rotation never overwrites a buffer that a queued
    kernel still reads;
  - positions on separate cards of one process: a copy on side streams
    (:class:`_SideStreams`), ordered by CUDA events only: it waits for the
    event that marks the source block as delivered and for the release of
    the buffer it writes into (the visitor two steps back), and the
    receiving card's compute stream waits for its delivery event just
    before the step that reads it.  No call waits on the host;
  - between ranks: ``batch_isend_irecv`` into fresh buffers, posted before
    the step's tiles are queued and waited on (``Work.wait()``: a stream
    wait on NCCL, a host wait on gloo) just before the next step.
* Each sub-tile runs the count kernel: ``indexed_kernel`` (the CUDA
  kernel's indexed entry, ``planes_j=``/``panel_j=`` into the resident and
  visiting blocks) when given, else ``kernel`` on sliced rows.  The wrap
  step's higher half reads the visitor at row offset ``p1`` through the
  indexed entry: the CUDA kernel takes any offset, where the Pallas kernel
  needed a sliced copy.
* Each sub-tile's hits go through the emit step (ops/king_emit.py: one CUDA
  kernel on a card) into one fixed-capacity :class:`HitBuffer` per position,
  whose device count stays exact past capacity.  After the sweep each
  position's count is read once and the counts are all-reduced, so the
  overflow retry (``_run_with_retry``) and the overflow errors
  (``_check_overflow``) are decided the same way on every rank: the
  reference's global ``max_results`` bound (cuking.cu:747-751).

On a card a sub-tile is two kernel launches on its device's current
stream, and nothing in the step loop waits for a device.  A step's
sub-tiles are queued round robin over the local positions
(:func:`_interleave`), so every card has work from the step's start.  On
one card no rotation copies anything.  On four H100s (700 W) a ring of
one position per card returned the engine's rows at 1.02-1.035 of one
card's pairs/s per GPU for D = 2-4; ``tools/torch_scaling_bench.py``
measures that and the share of transfer time under count-kernel time.
"""

from __future__ import annotations

import itertools
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from cuking_tpu_torch.models.king import DEFAULT_MAX_RESULTS, ResultSet
from cuking_tpu_torch.ops.compaction import HitBuffer
from cuking_tpu_torch.ops.king_emit import emit_hits
from cuking_tpu_torch.ops.king_math import KingCounts
from cuking_tpu_torch.utils.status import InvalidArgumentError, ResourceExhaustedError

AXIS = "samples"  # the name of the mesh's one axis, as in the TPU package


def ring_num_steps(num_devices: int) -> int:
    """Steps of the balanced schedule: ⌈(D+1)/2⌉, plus the half-active
    wrap step for even D."""
    return num_devices // 2 + 1 if num_devices % 2 == 0 else (num_devices + 1) // 2


def ring_schedule(num_devices: int) -> list[tuple[int, int, int, float]]:
    """Executable specification of the schedule: (position, step,
    col_block, work_fraction) for every (position, step).  The wrap step of
    an even-D ring (2t == D) is shared: BOTH positions of pair {d, d+D/2}
    compute half the block (fraction 0.5)."""
    d_ = num_devices
    sched = []
    for t in range(ring_num_steps(d_)):
        for dev in range(d_):
            frac = 1.0 if 2 * t < d_ else 0.5
            sched.append((dev, t, (dev + t) % d_, frac))
    return sched


def default_capacity_per_device(max_results: int, num_devices: int) -> int:
    """Per-position hit-buffer size for a global ``max_results``: 2× the
    even share (floored at 2¹⁴, capped at the global limit).  Row-skewed hits
    beyond it auto-retry once at a pow2-bucketed capacity."""
    return min(max_results, max(2 * (-(-max_results // num_devices)), 1 << 14))


class RingMesh:
    """The ring positions, in mesh order.

    ``devices[p]`` is position p's torch device and ``ranks[p]`` the process
    that owns it; ``rank`` is this process and ``local_positions`` its
    positions.  A mesh built with :meth:`from_process_group` rotates between
    ranks with ``torch.distributed``; otherwise every position is local."""

    def __init__(self, devices, ranks=None, rank: int = 0, distributed: bool = False):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise InvalidArgumentError("A ring mesh needs at least one position")
        self.ranks = tuple(ranks) if ranks is not None else (rank,) * len(self.devices)
        self.rank = rank
        self.distributed = distributed
        self.local_positions = tuple(
            p for p, r in enumerate(self.ranks) if r == rank
        )

    @classmethod
    def from_process_group(cls, local_devices) -> "RingMesh":
        """The mesh over every rank of the initialised default process
        group: each rank passes its own devices, and positions are laid out
        rank by rank.  Collective: every rank must call it."""
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, [str(d) for d in local_devices])
        devices = [d for per_rank in gathered for d in per_rank]
        ranks = [r for r, per_rank in enumerate(gathered) for _ in per_rank]
        return cls(devices, ranks, dist.get_rank(), distributed=True)

    @property
    def size(self) -> int:
        return len(self.devices)

    def all_reduce(self, values, op: str = "sum") -> np.ndarray:
        """Element-wise ``sum`` or ``min`` of an int64 vector over the
        mesh's ranks; the identity on a single-process mesh."""
        arr = np.asarray(values, dtype=np.int64)
        if not self.distributed:
            return arr
        # NCCL reduces CUDA tensors only, gloo CPU ones.
        device = (
            self.devices[self.local_positions[0]]
            if dist.get_backend() == "nccl"
            else torch.device("cpu")
        )
        t = torch.from_numpy(arr.copy()).to(device)
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MIN)
        return t.cpu().numpy()

    def __repr__(self) -> str:
        return f"RingMesh(devices={[str(d) for d in self.devices]}, ranks={self.ranks}, rank={self.rank})"


class RingOutput(NamedTuple):
    """The ring's hits: this process's per-position buffers, and the exact
    totals of every position."""

    hits: tuple  # per local position: [6, capacity] int32 rows (i, j, kin bits, ibs0, ibs1, ibs2)
    counts: np.ndarray  # [D] int64 exact per-position totals (may exceed capacity), all ranks
    positions: tuple  # the mesh positions of ``hits``

    @property
    def capacity_per_device(self) -> int:
        return self.hits[0].shape[1]


def _choose_sub_panel(nd: int, requested: int, row_multiple: int = 1) -> int:
    """Largest sub-panel ≤ requested that divides the per-position row count
    and respects the kernel's row multiple; falls back to the whole block."""
    for p in range(min(requested, nd), 0, -1):
        if nd % p == 0 and p % row_multiple == 0:
            return p
    return nd


def _wrap_split(p: int, row_multiple: int) -> int:
    """Row count of the lower position's share when the even-D wrap block
    is a SINGLE sub-tile: ~p/2 rounded to a legal panel size, 0 when
    unsplittable (the whole block then goes to the higher position).  The
    port's kernels take any size (row_multiple 1); the rule for larger
    multiples is the TPU package's."""
    if p >= 2 * row_multiple:
        return (p // (2 * row_multiple)) * row_multiple
    if row_multiple == 1:
        return p // 2 if p >= 2 else 0
    half = (p // 2) // 8 * 8
    if half >= 8 and half <= row_multiple and p - half <= row_multiple:
        return half
    return 0


def _rows(planes: torch.Tensor, lo: int, n: int) -> torch.Tensor:
    return planes[:, lo : lo + n].contiguous()


def _sub_counts(kernel, indexed_kernel, planes_i, i_off, ni, planes_j, j_off, nj,
                tri) -> KingCounts:
    """Counts of rows [i_off, i_off+ni) of ``planes_i`` × rows [j_off,
    j_off+nj) of ``planes_j``: through the indexed entry when there is one
    (no row copies), else the sliced ``kernel``."""
    if indexed_kernel is not None:
        return indexed_kernel(planes_i, i_off, j_off, tri, panel=ni,
                              planes_j=planes_j, panel_j=nj)
    return kernel(_rows(planes_i, i_off, ni), _rows(planes_j, j_off, nj), tri)


def _emit(hits: HitBuffer, counts: KingCounts, threshold: float,
          gi_base: int, gj_base: int, i_limit: int, j_limit: int,
          same: bool = False) -> None:
    """Epilogue + threshold + compaction of one sub-tile.  ``same`` marks a
    sub-tile on the global diagonal (strict i < j, cuking.cu:199).  KING is
    pair-symmetric, so a pair computed with the higher block resident still
    emits (min, max)."""
    emit_hits(counts, hits, gi_base, gj_base, i_limit, j_limit, threshold,
              strict=same, sym=True)


class _SideStreams:
    """The side streams of one ring run's copies between the cards of this
    process: per card, a stream that copies its blocks out and one that
    receives into it, so a copy is ordered by events and never queues
    behind the compute of either card.

    PyTorch runs a copy between two cards on the SOURCE card's current
    stream, after an event of the DESTINATION card's current stream, and
    makes the latter wait for the copy; :meth:`copy` makes both side
    streams current around it.  Received blocks are allocated on the
    receive stream and are read by the card's compute stream and by its
    send stream, so before a step drops one, :meth:`release` orders the
    receive stream after both: the caching allocator then gives its memory
    to the next receive without a host wait, and the copy into it waits for
    the step that read it.  ``start`` holds, per card, an event at the
    compute stream's point when the run began, where the resident blocks
    are delivered."""

    def __init__(self, blocks):
        self.start = {d: torch.cuda.current_stream(d).record_event()
                      for d in {b.device for b in blocks} if d.type == "cuda"}
        self.pairs: dict = {}

    def _pair(self, device) -> tuple:
        if device not in self.pairs:
            self.pairs[device] = (torch.cuda.Stream(device), torch.cuda.Stream(device))
        return self.pairs[device]

    def copy(self, buf: torch.Tensor, ready, device) -> tuple:
        """Queues a copy of ``buf`` into a new tensor on ``device`` behind
        ``ready`` (the event of ``buf``'s delivery; None for a block
        resident since the run began), and returns the new tensor with the
        event of its delivery."""
        send = self._pair(buf.device)[0]
        recv = self._pair(device)[1]
        send.wait_event(ready if ready is not None else self.start[buf.device])
        with torch.cuda.stream(recv):
            out = torch.empty_like(buf, device=device)
            with torch.cuda.stream(send):
                out.copy_(buf)
            recv.wait_stream(send)  # on one card PyTorch adds no such wait
            return out, recv.record_event()

    def release(self) -> None:
        """Orders each card's receive stream after what its compute and
        send streams have queued: called before the blocks they read are
        dropped."""
        for device, (send, recv) in self.pairs.items():
            recv.wait_stream(torch.cuda.current_stream(device))
            recv.wait_stream(send)

    def join(self) -> None:
        """Ends the run: each card's compute stream waits for its side
        streams, and they for it, so nothing queued later on either reuses
        a block under a queued reader."""
        self.release()
        for device, (send, recv) in self.pairs.items():
            compute = torch.cuda.current_stream(device)
            compute.wait_stream(send)
            compute.wait_stream(recv)


class _Rotation(NamedTuple):
    """One backwards rotation in flight: ``blocks[d]`` is what position d
    will read, as (tensor, delivery event or None), and ``works`` the
    requests of its transfers between ranks, into ``from_ranks``."""

    blocks: dict
    works: list
    from_ranks: tuple


def _start_rotation(bufs: dict, mesh: RingMesh, streams: _SideStreams) -> _Rotation:
    """Starts the backwards rotation: position d will receive position
    d+1's block.  ``bufs`` maps each local position to (tensor, delivery
    event or None).  A receiver on the same device gets the tensor itself;
    one on another card of this process a copy on the side streams; a
    remote one a fresh buffer from ``batch_isend_irecv``, posted here."""
    d_ = mesh.size
    out, ops, from_ranks = {}, [], []
    for e, (buf, ready) in bufs.items():
        dst = (e - 1) % d_
        if mesh.ranks[dst] != mesh.rank:
            ops.append(dist.P2POp(dist.isend, buf, mesh.ranks[dst], tag=dst))
            continue
        device = bufs[dst][0].device  # the receiver's own, index resolved
        if device == buf.device:
            out[dst] = (buf, ready)
        else:
            out[dst] = streams.copy(buf, ready, device)
    for d, (buf, _) in bufs.items():
        src = (d + 1) % d_
        if mesh.ranks[src] != mesh.rank:
            recv = torch.empty_like(buf)
            out[d] = (recv, None)
            from_ranks.append(d)
            ops.append(dist.P2POp(dist.irecv, recv, mesh.ranks[src], tag=d))
    works = dist.batch_isend_irecv(ops) if ops else []
    return _Rotation(out, works, tuple(from_ranks))


def _finish_rotation(rotation: _Rotation, streams: _SideStreams) -> dict:
    """Finishes a rotation just before the first sub-tile of the step that
    reads it: waits for the transfers between ranks (on NCCL the current
    stream waits; on gloo the host, after the step before was computed),
    makes each compute stream wait for the copies delivered to its card,
    and releases the blocks the step before read.  Returns the rotated
    ``bufs``."""
    for work in rotation.works:
        work.wait()
    streams.release()
    blocks = dict(rotation.blocks)
    for d, (buf, ready) in blocks.items():
        if not buf.is_cuda:
            continue
        compute = torch.cuda.current_stream(buf.device)
        if d in rotation.from_ranks:
            blocks[d] = (buf, compute.record_event())  # for a copy onwards
        elif ready is not None:
            compute.wait_event(ready)
    return blocks


def _rotate(bufs: dict, mesh: RingMesh) -> dict:
    """One whole rotation of ``bufs`` (position → tensor), started and
    finished with no step between: what the ring's schedule does to its
    blocks from one step to the next."""
    streams = _SideStreams(bufs.values())
    rotation = _start_rotation({p: (b, None) for p, b in bufs.items()}, mesh, streams)
    out = _finish_rotation(rotation, streams)
    streams.join()
    return {p: b for p, (b, _) in out.items()}


def _finish(hits: dict, mesh: RingMesh) -> RingOutput:
    counts = np.zeros(mesh.size, np.int64)
    for p, h in hits.items():
        counts[p] = int(h.count)  # the position's one read of its count
    return RingOutput(
        hits=tuple(hits[p].buf for p in mesh.local_positions),
        counts=mesh.all_reduce(counts),
        positions=mesh.local_positions,
    )


def _check_blocks(blocks, mesh: RingMesh) -> None:
    if len(blocks) != len(mesh.local_positions):
        raise InvalidArgumentError(
            f"{len(blocks)} blocks for {len(mesh.local_positions)} local ring positions"
        )
    shapes = {tuple(b.shape) for b in blocks}
    if len(shapes) != 1:
        raise InvalidArgumentError(f"ring blocks differ in shape: {sorted(shapes)}")


def _interleave(per_position: list) -> list:
    """A step's sub-tiles, one position's after another's in turn: each
    sub-tile launches on its own position's device, so the host gives every
    card work from the step's start, where queuing one position's whole
    step before the next one's left the later cards idle meanwhile.  Each
    position keeps its own order, so its hits land as before."""
    return [args for group in itertools.zip_longest(*per_position)
            for args in group if args is not None]


def _ring_fn(
    blocks: list,
    threshold: float,
    mesh: RingMesh,
    *,
    kernel: Callable,
    num_samples: int,
    capacity: int,
    sub_panel: int | None = None,
    row_offset: int = 0,
    row_multiple: int = 1,
    indexed_kernel: Callable | None = None,
) -> RingOutput:
    """The triangular ring over this process's blocks ([2, nd, W] int32,
    one per local position).  Each position's nd×nd pair block of a step
    runs in ``sub_panel``-sized sub-tiles, bounding a step's transients.
    ``row_offset`` shifts emitted indices when the ring sweeps one diagonal
    Submatrix block (cuking.cu:129-179); ``num_samples`` counts the block's
    samples, and padding rows past it mask themselves out."""
    d_ = mesh.size
    local = dict(zip(mesh.local_positions, blocks))
    nd = blocks[0].shape[1]
    p = sub_panel or nd
    assert nd % p == 0, (nd, p)
    ns = nd // p
    row_limit = row_offset + num_samples
    hits = {me: HitBuffer(capacity, mesh.devices[me]) for me in local}

    def tile(me, planes_j, i_off, ni, j_off, nj, gj_base, same=False):
        counts = _sub_counts(kernel, indexed_kernel, local[me], i_off, ni,
                             planes_j, j_off, nj, int(same))
        _emit(hits[me], counts, threshold, row_offset + me * nd + i_off, gj_base,
              row_limit, row_limit, same)

    num_steps = ring_num_steps(d_)
    streams = _SideStreams(blocks)
    bufs = {me: (local[me], None) for me in local}
    # The first rotation starts before step 0: the resident block's own
    # upper triangle of sub-tiles, whose diagonal sub-tiles take the
    # kernel's tri tile skip.
    rotation = _start_rotation(bufs, mesh, streams) if num_steps > 1 else None
    for args in _interleave([
        [(me, local[me], ii * p, p, jj * p, p, row_offset + me * nd + jj * p, ii == jj)
         for ii in range(ns) for jj in range(ii, ns)]
        for me in local
    ]):
        tile(*args)

    for t in range(1, num_steps):
        bufs = _finish_rotation(rotation, streams)
        rotation = _start_rotation(bufs, mesh, streams) if t + 1 < num_steps else None
        per_position = []
        for me in local:
            gj0 = row_offset + ((me + t) % d_) * nd
            visitor = bufs[me][0]
            if 2 * t < d_:
                # Full steps: the visitor is disjoint from the resident
                # block, so the whole ns×ns sub-grid is useful work.
                pairs = [(ii, jj) for ii in range(ns) for jj in range(ns)]
            elif ns == 1 and _wrap_split(p, row_multiple):
                # Wrap step of even D, one sub-tile: split inside it.  The
                # lower position takes resident rows [0, p1) × the whole
                # visitor, the higher one its whole resident block × visitor
                # rows [p1, p) — in canonical terms, the lower block's rows
                # [0, p1) and [p1, p).
                p1 = _wrap_split(p, row_multiple)
                if 2 * me < d_:
                    per_position.append([(me, visitor, 0, p1, 0, p, gj0)])
                else:
                    per_position.append([(me, visitor, 0, p, p1, p - p1, gj0 + p1)])
                continue
            else:
                # Wrap step of even D: the lower position takes sub-rows
                # [0, h) × the visitor, the higher one its resident block ×
                # the visitor's sub-cols [h, ns).
                h = ns // 2
                if 2 * me < d_:
                    pairs = [(ii, jj) for ii in range(h) for jj in range(ns)]
                else:
                    pairs = [(ii, jj) for ii in range(ns) for jj in range(h, ns)]
            per_position.append([(me, visitor, ii * p, p, jj * p, p, gj0 + jj * p)
                                 for ii, jj in pairs])
        for args in _interleave(per_position):
            tile(*args)
    streams.join()
    return _finish(hits, mesh)


def _rect_ring_fn(
    blocks_i: list,
    blocks_j: list,
    threshold: float,
    mesh: RingMesh,
    *,
    kernel: Callable,
    i_offset: int,
    i_count: int,
    j_offset: int,
    j_count: int,
    capacity: int,
    sub_panel_i: int | None,
    sub_panel_j: int | None,
    indexed_kernel: Callable | None = None,
) -> RingOutput:
    """The rectangular ring of an OFF-DIAGONAL Submatrix shard: every pair
    (r, c), r in the shard's row block, c in its column block (disjoint
    ranges, cuking.cu:158-175, so no triangle masking).  The i-blocks stay
    resident and the j-blocks rotate for D steps."""
    d_ = mesh.size
    local_i = dict(zip(mesh.local_positions, blocks_i))
    nd_i, nd_j = blocks_i[0].shape[1], blocks_j[0].shape[1]
    p_i = sub_panel_i or nd_i
    p_j = sub_panel_j or nd_j
    assert nd_i % p_i == 0 and nd_j % p_j == 0, (nd_i, p_i, nd_j, p_j)
    i_limit = i_offset + i_count
    j_limit = j_offset + j_count
    hits = {me: HitBuffer(capacity, mesh.devices[me]) for me in local_i}
    streams = _SideStreams(blocks_j)
    bufs = {me: (b, None) for me, b in zip(mesh.local_positions, blocks_j)}
    for t in range(d_):
        # Rotation t+1 starts before step t's sub-tiles and is finished
        # after them; the last step needs none.
        rotation = _start_rotation(bufs, mesh, streams) if t + 1 < d_ else None
        for me, ii, jj in _interleave([
            [(me, ii, jj) for ii in range(nd_i // p_i) for jj in range(nd_j // p_j)]
            for me in local_i
        ]):
            counts = _sub_counts(kernel, indexed_kernel, local_i[me],
                                 ii * p_i, p_i, bufs[me][0], jj * p_j, p_j, 0)
            _emit(hits[me], counts, threshold,
                  i_offset + me * nd_i + ii * p_i,
                  j_offset + ((me + t) % d_) * nd_j + jj * p_j, i_limit, j_limit)
        if rotation is not None:
            bufs = _finish_rotation(rotation, streams)
    streams.join()
    return _finish(hits, mesh)


def _device_block(planes: np.ndarray, lo: int, nd: int, device) -> torch.Tensor:
    """Rows [lo, lo + nd) of host uint32 planes as a [2, nd, W] int32 tensor
    on ``device``; rows past the array are all-missing padding."""
    block = np.full((2, nd, planes.shape[2]), 0xFFFFFFFF, np.uint32)
    hi = min(lo + nd, planes.shape[1])
    if hi > lo:
        block[:, : hi - lo] = planes[:, lo:hi]
    return torch.from_numpy(block.view(np.int32)).to(device)


def _pad_and_shard(
    planes: np.ndarray, count: int, mesh: RingMesh, row_multiple: int
) -> tuple[list, int]:
    """Splits host [2, n, W] uint32 planes into D row blocks of an even
    per-position size (a ``row_multiple`` multiple), padded with all-missing
    rows, and places this process's blocks on their devices.  Rows may
    already carry padding beyond ``count``, so the pad target is
    max(count, n).  Padding self-masks through the validity bound."""
    planes = np.asarray(planes)
    num_devices = mesh.size
    n = planes.shape[1]
    nd = -(-max(count, n, 1) // num_devices)
    nd = -(-nd // row_multiple) * row_multiple
    blocks = [
        _device_block(planes, p * nd, nd, mesh.devices[p])
        for p in mesh.local_positions
    ]
    return blocks, nd


def all_pairs_sharded(
    planes: np.ndarray,  # [2, N_stored, W] uint32, on the host
    num_samples: int,
    mesh: RingMesh,
    kernel: Callable,
    *,
    kin_threshold: float,
    capacity_per_device: int = 1 << 20,
    row_multiple: int = 1,
    max_results: int | None = None,
    auto_retry: bool = True,
    sub_panel: int | None = 1024,
    row_offset: int = 0,
    indexed_kernel: Callable | None = None,
) -> RingOutput:
    """Runs the triangular ring over the mesh; returns per-position hits.

    ``planes`` is padded (all-ones = missing) up to ``D * ceil(N/D)`` rows,
    split into row blocks, and each local block placed on its position's
    device.  ``sub_panel`` bounds per-step transients (``None`` = whole
    block)."""
    blocks, _ = _pad_and_shard(planes, num_samples, mesh, row_multiple)
    return all_pairs_presharded(
        blocks, num_samples, mesh, kernel,
        kin_threshold=kin_threshold, capacity_per_device=capacity_per_device,
        max_results=max_results, auto_retry=auto_retry,
        sub_panel=sub_panel, row_multiple=row_multiple,
        row_offset=row_offset, indexed_kernel=indexed_kernel,
    )


def all_pairs_presharded(
    blocks: list,  # [2, nd, W] int32, one per local position, on its device
    num_samples: int,
    mesh: RingMesh,
    kernel: Callable,
    *,
    kin_threshold: float,
    capacity_per_device: int = 1 << 20,
    max_results: int | None = None,
    auto_retry: bool = True,
    sub_panel: int | None = 1024,
    row_multiple: int = 1,
    row_offset: int = 0,
    indexed_kernel: Callable | None = None,
) -> RingOutput:
    """Triangular ring over blocks that are ALREADY on their positions'
    devices: the multi-process entry point, where each rank builds only its
    own positions' blocks (parallel/distributed.py).  Padding rows (global
    index ≥ num_samples) must be all-ones (missing).

    Overflow recovery: per-position totals stay exact past capacity, so a
    row-skewed run whose buffers overflow while the GLOBAL total is within
    ``max_results`` (cuking.cu:747-751) re-runs once at a pow2-bucketed
    capacity.  Every rank takes the same decision from the all-reduced
    counts.  ``auto_retry=False`` fails fast instead."""
    _check_blocks(blocks, mesh)
    nd = blocks[0].shape[1]
    p = _choose_sub_panel(nd, sub_panel, row_multiple) if sub_panel else None

    def run(capacity: int) -> RingOutput:
        return _ring_fn(
            blocks, kin_threshold, mesh, kernel=kernel, num_samples=num_samples,
            capacity=capacity, sub_panel=p, row_offset=row_offset,
            row_multiple=row_multiple, indexed_kernel=indexed_kernel,
        )

    return _run_with_retry(run, capacity_per_device, max_results, auto_retry)


def _run_with_retry(
    run: Callable[[int], RingOutput],
    capacity_per_device: int,
    max_results: int | None,
    auto_retry: bool,
) -> RingOutput:
    """Shared overflow auto-retry: a buffer overflow is re-run once at a
    bigger capacity, but only when the run is going to SUCCEED: the global
    total must be within max_results (the reference's default when the
    caller gave none, so an unbounded keep-everything run fails cleanly
    instead of allocating its overflow per position).  The retry capacity is
    the next power of two (≤ the global limit), as in the TPU package, where
    capacity was a compile-cache key.  The first run's hit buffers are
    freed before the retry allocates its own, so a position never holds two
    sets (the one set ``utils/hbm.check_ring_fit`` budgets)."""
    out = run(capacity_per_device)
    if not auto_retry:
        return out
    counts = ring_global_counts(out)
    over = int(counts.max(initial=0))
    limit = DEFAULT_MAX_RESULTS if max_results is None else max_results
    if over > capacity_per_device and int(counts.sum()) <= limit:
        del out
        bucket = 1 << (over - 1).bit_length()
        return run(min(bucket, limit))
    return out


def rect_pairs_sharded(
    planes_i: np.ndarray,  # [2, rows_stored, W] i-range rows, host uint32
    planes_j: np.ndarray,  # [2, cols_stored, W] j-range rows
    i_count: int,
    j_count: int,
    mesh: RingMesh,
    kernel: Callable,
    *,
    i_offset: int,
    j_offset: int,
    kin_threshold: float,
    capacity_per_device: int = 1 << 20,
    row_multiple: int = 1,
    max_results: int | None = None,
    auto_retry: bool = True,
    sub_panel: int | None = 1024,
    indexed_kernel: Callable | None = None,
) -> RingOutput:
    """Rectangular ring of an OFF-DIAGONAL Submatrix shard over the mesh:
    all pairs (r, c), r in the i-range, c in the j-range; both ranges are
    split over the positions and the j-blocks rotate.  This composes
    --split_factor with --use_mesh (README.md:94-102)."""
    blocks_i, _ = _pad_and_shard(planes_i, i_count, mesh, row_multiple)
    blocks_j, _ = _pad_and_shard(planes_j, j_count, mesh, row_multiple)
    return rect_pairs_presharded(
        blocks_i, blocks_j, i_count, j_count, mesh, kernel,
        i_offset=i_offset, j_offset=j_offset, kin_threshold=kin_threshold,
        capacity_per_device=capacity_per_device, row_multiple=row_multiple,
        max_results=max_results, auto_retry=auto_retry, sub_panel=sub_panel,
        indexed_kernel=indexed_kernel,
    )


def rect_pairs_presharded(
    blocks_i: list,  # [2, nd_i, W] int32 per local position
    blocks_j: list,  # [2, nd_j, W] int32 per local position
    i_count: int,
    j_count: int,
    mesh: RingMesh,
    kernel: Callable,
    *,
    i_offset: int,
    j_offset: int,
    kin_threshold: float,
    capacity_per_device: int = 1 << 20,
    row_multiple: int = 1,
    max_results: int | None = None,
    auto_retry: bool = True,
    sub_panel: int | None = 1024,
    indexed_kernel: Callable | None = None,
) -> RingOutput:
    """Rectangular ring over blocks already on their devices: the
    multi-process entry point (each rank holds only its positions' blocks
    of both ranges, parallel/distributed.py)."""
    _check_blocks(blocks_i, mesh)
    _check_blocks(blocks_j, mesh)
    nd_i, nd_j = blocks_i[0].shape[1], blocks_j[0].shape[1]
    p_i = _choose_sub_panel(nd_i, sub_panel, row_multiple) if sub_panel else None
    p_j = _choose_sub_panel(nd_j, sub_panel, row_multiple) if sub_panel else None

    def run(capacity: int) -> RingOutput:
        return _rect_ring_fn(
            blocks_i, blocks_j, kin_threshold, mesh, kernel=kernel,
            i_offset=i_offset, i_count=i_count, j_offset=j_offset,
            j_count=j_count, capacity=capacity, sub_panel_i=p_i,
            sub_panel_j=p_j, indexed_kernel=indexed_kernel,
        )

    return _run_with_retry(run, capacity_per_device, max_results, auto_retry)


def submatrix_pairs_sharded(
    storage,  # PanelStorage holding one shard's i-range (+ j-range) planes
    mesh: RingMesh,
    kernel: Callable,
    *,
    kin_threshold: float,
    capacity_per_device: int = 1 << 20,
    row_multiple: int = 1,
    max_results: int | None = None,
    auto_retry: bool = True,
    sub_panel: int | None = 1024,
    indexed_kernel: Callable | None = None,
) -> RingOutput:
    """Sweeps ONE Submatrix shard (any split_factor) over the mesh ring: a
    diagonal shard is the triangular ring over its block with a global row
    offset; an off-diagonal shard is the rectangular ring.  Input is the
    engine's own PanelStorage (i-range rows stored before the j-range,
    cuking.cu:171-175), so CLI ingest is shared."""
    sm = storage.submatrix
    common = dict(
        kin_threshold=kin_threshold, capacity_per_device=capacity_per_device,
        row_multiple=row_multiple, max_results=max_results,
        auto_retry=auto_retry, sub_panel=sub_panel, indexed_kernel=indexed_kernel,
    )
    if sm.is_diagonal:
        return all_pairs_sharded(
            storage.planes, sm.num_rows, mesh, kernel, row_offset=sm.i_begin,
            **common,
        )
    return rect_pairs_sharded(
        storage.planes[:, : storage.j_store_base],
        storage.planes[:, storage.j_store_base :],
        sm.num_rows, sm.num_cols, mesh, kernel,
        i_offset=sm.i_begin, j_offset=sm.j_begin, **common,
    )


def ring_global_counts(out: RingOutput) -> np.ndarray:
    """The exact [D] per-position hit totals, the same on every rank (they
    were all-reduced when the sweep ended).  The reference's
    ``--max_results`` bounds the GLOBAL count (cuking.cu:747-751)."""
    return out.counts


def _check_overflow(
    counts: np.ndarray, capacity_per_device: int, max_results: int | None
) -> None:
    if (counts > capacity_per_device).any():
        raise ResourceExhaustedError(
            "Could not store all results: a device's hit buffer overflowed "
            f"(max {int(counts.max())} hits vs capacity {capacity_per_device}). "
            "Hits are row-skewed beyond the auto-retry bound; increase "
            "--max_results or pass a larger capacity_per_device."
        )
    if max_results is not None and counts.sum() > max_results:
        # The reference's semantic: the GLOBAL count is bounded
        # (cuking.cu:747-751).
        raise ResourceExhaustedError(
            "Could not store all results: try increasing the "
            "--max_results parameter."
        )


def ring_output_local_resultset(
    out: RingOutput, max_results: int | None = None
) -> ResultSet:
    """This process's positions' hits as a sorted ResultSet: each rank
    writes its own output partition, keeping the reference's trivially
    mergeable output (README.md:102).  Overflow and the global
    ``max_results`` bound are checked against the all-reduced counts, so
    every rank raises together."""
    _check_overflow(ring_global_counts(out), out.capacity_per_device, max_results)
    parts = [
        ResultSet.from_rows(buf[:, : int(out.counts[p])].cpu().numpy())
        for p, buf in zip(out.positions, out.hits)
        if out.counts[p]
    ]
    return ResultSet.concat_and_sort(parts)


def ring_output_to_resultset(
    out: RingOutput, max_results: int | None = None
) -> ResultSet:
    """Every position's hits as one sorted ResultSet; raises on overflow
    like cuking.cu:747-751.  Needs every position in this process: a
    multi-process run takes :func:`ring_output_local_resultset`."""
    if len(out.positions) != len(out.counts):
        raise InvalidArgumentError(
            f"This process holds {len(out.positions)} of the ring's "
            f"{len(out.counts)} positions; use ring_output_local_resultset"
        )
    return ring_output_local_resultset(out, max_results)
