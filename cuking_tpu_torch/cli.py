"""Port of ``cuking_tpu/cli.py``: the end-to-end pipeline (reference:
cuking.cu:435-895).

Same eight flags as the reference binary (cuking.cu:27-52), same validation,
same stages: read metadata → build shard Submatrix → allocate planes →
list+ingest Parquet in parallel → all-pairs KING (the panel sweep on
``--device``, or the ring over several positions with ``--use_mesh``) →
overflow check → sort → write one Snappy Parquet partition per shard.

``--keep_all`` writes every pair i < j of the shard, whatever its kin (NaN
and ±inf included), as Hail's ``hl.king`` returns the whole kinship
matrix: the engine's hit buffer is made at exactly the shard's pairs, so the
sweep runs once.  It takes no ``--kin_threshold`` and no ``--use_mesh``;
a shard whose pairs pass ``--max_results`` fails before ingest, naming the
value needed.

``--device`` (default ``cuda``) names the torch device.  Without a CUDA
device the default fails with exit code 1; ``--device cpu`` runs the plain
PyTorch count path.  Under ``--use_mesh`` it takes a comma-separated list of
ring positions (default: every visible CUDA device).  ``--distributed``
starts ``torch.distributed`` from the ``torchrun`` environment
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``): NCCL for CUDA
positions, gloo for CPU ones.  ``--profile_dir`` writes a ``torch.profiler``
Chrome trace of the task, from metadata to write, with the port's spans
(``utils/stopwatch.py``), one file per output partition.  The TPU package's
``--tile_i/--tile_j`` and ``--[no-]indexed_panels`` have no counterpart and
are rejected: the first set the Pallas kernel's Mosaic tile edges, and the
CUDA kernel's tiles are fixed by its ``wgmma`` shape; the second chooses
between two Pallas entries, while the CUDA kernel reads every panel in
place through row offsets, so its sliced form would only add two panel
copies per step in front of the same kernel.

Usage::

    python -m cuking_tpu_torch.cli --input_uri gs://bucket/in.parquet \
        --output_uri gs://bucket/out.parquet --kin_threshold 0.0884 \
        --split_factor 4 --shard_index 3
    # The whole kinship matrix of a small cohort, every pair a row:
    python -m cuking_tpu_torch.cli --input_uri gs://bucket/in.parquet \
        --output_uri gs://bucket/all-pairs.parquet --keep_all
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
from datetime import timedelta

from cuking_tpu_torch.io.metadata import read_metadata
from cuking_tpu_torch.io.parquet_ingest import ingest_parquet
from cuking_tpu_torch.io.uri import Storage
from cuking_tpu_torch.io.writer import partition_is_valid, partition_name, write_results
from cuking_tpu_torch.models.king import (
    DEFAULT_KIN_THRESHOLD,
    DEFAULT_MAX_RESULTS,
    KERNELS,
    KingConfig,
    KingEngine,
    PanelStorage,
    keep_all_slots,
    resolve_indexed_kernel,
    resolve_kernel,
    resolve_kernel_name,
)
from cuking_tpu_torch.ops.bitset import PlaneLayout
from cuking_tpu_torch.ops.compaction import ceil_pow2
from cuking_tpu_torch.parallel.distributed import HostShardedStorage
from cuking_tpu_torch.parallel.ring import (
    RingMesh,
    all_pairs_presharded,
    default_capacity_per_device,
    rect_pairs_presharded,
    ring_output_local_resultset,
    ring_output_to_resultset,
    submatrix_pairs_sharded,
)
from cuking_tpu_torch.parallel.submatrix import Submatrix, num_shards
from cuking_tpu_torch.utils.hbm import check_engine_fit, check_ring_fit, device_bytes_limit
from cuking_tpu_torch.utils.status import (
    CukingError,
    FailedPreconditionError,
    InvalidArgumentError,
)
from cuking_tpu_torch.utils.stopwatch import (
    StageLogger,
    chrome_events,
    now_ns,
    recorded,
    span,
)
from cuking_tpu_torch.utils.trace import append_events

# How long a rank waits for its peers at the env:// rendezvous, and for a
# collective or a ring rotation afterwards (long: ranks reach the first
# rotation only after their own Parquet ingest, which may be skewed).
RENDEZVOUS_TIMEOUT = timedelta(minutes=2)
COLLECTIVE_TIMEOUT = timedelta(minutes=30)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cuking_tpu_torch",
        description="KING relatedness on an NVIDIA GPU over cuKING-format Parquet inputs.",
    )
    p.add_argument("--input_uri", default="", help=(
        "Directory (local or gs://) containing the packed Parquet tables "
        "and metadata.json"))
    p.add_argument("--output_uri", default="", help=(
        "Directory (local or gs://) to write the Parquet result partition to"))
    p.add_argument("--requester_pays_project", default="", help=(
        "User project for accessing Requester Pays buckets on GCS"))
    p.add_argument("--num_reader_threads", type=int, default=36, help=(
        "Threads for parallel Parquet ingest"))
    p.add_argument("--max_results", type=int, default=DEFAULT_MAX_RESULTS, help=(
        "Capacity of the related-pair result buffer; exceeding it is an error"))
    p.add_argument("--kin_threshold", type=float, default=None,
                   help=("Only store kinship coefficients strictly larger than "
                         f"this threshold (default: {DEFAULT_KIN_THRESHOLD}, "
                         "2nd degree or closer)"))
    p.add_argument("--keep_all", action="store_true", help=(
        "Write every pair i < j of the shard, whatever its kinship (NaN and "
        "+/-inf included), as Hail's hl.king returns the whole matrix; the "
        "result buffer is sized to the shard's pairs, which must not exceed "
        "--max_results. Takes no --kin_threshold and no --use_mesh"))
    p.add_argument("--split_factor", type=int, default=1, help=(
        "Split the relatedness matrix into k x k submatrices for sharding"))
    p.add_argument("--shard_index", type=int, default=0, help=(
        "Shard index in [0, split_factor*(split_factor+1)/2)"))
    # Extensions (no reference counterpart):
    p.add_argument("--kernel", default="auto", choices=list(KERNELS),
                   help=("Count kernel: cuda (the hand-written CUDA kernel), "
                         "matmul (the plain PyTorch int8 product) or popcount "
                         "(the plain AND + popcount path, any device); auto: "
                         "cuda on a CUDA device, matmul elsewhere. The TPU "
                         "package's pallas has no meaning on a GPU"))
    p.add_argument("--device", default=None, help=(
        "Torch device for the sweep (default cuda; cpu runs the plain "
        "PyTorch path). Under --use_mesh, a comma-separated list of ring "
        "positions, one entry each, e.g. cuda:0,cuda:1 or cpu,cpu,cpu,cpu; "
        "a device may repeat, so several positions share it (the port's "
        "equivalent of the TPU package's XLA_FLAGS="
        "--xla_force_host_platform_device_count). Default under --use_mesh: "
        "every visible CUDA device; with --distributed, cuda:$LOCAL_RANK"))
    p.add_argument("--panel", type=int, default=1024,
                   help="Samples per panel (pair-tile edge) in the sweep")
    p.add_argument("--use_mesh", action="store_true", help=(
        "Run this shard over the ring positions of --device: the sample "
        "rows are split over the positions and the j-blocks rotate around "
        "the ring (composes with --split_factor for cohorts larger than "
        "device memory; replaces the reference's share-nothing multi-GPU "
        "fan-out)"))
    p.add_argument("--distributed", action="store_true", help=(
        "Several processes, one ring: torch.distributed starts from the "
        "torchrun environment (MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE; "
        "NCCL for CUDA positions, gloo for CPU ones), each rank contributes "
        "its --device positions, ingests only their sample row blocks and "
        "writes its own disjoint output partition (implies --use_mesh; "
        "composes with --split_factor — partitions are then keyed by "
        "shard x rank)"))
    p.add_argument("--allow_single_process", action="store_true", help=(
        "With --distributed: proceed single-process when torch.distributed "
        "fails to start even though the environment looks like a "
        "multi-process run (normally a fatal error: degraded ranks would "
        "each compute a partial ring and race on part-00000)"))
    p.add_argument("--capacity_per_device", type=int, default=0, help=(
        "Hit-buffer slots per ring position (0 = auto: 2x the even share "
        "of --max_results). Row-skewed hit distributions auto-retry at a "
        "pow2-bucketed capacity, so this is only a memory knob"))
    p.add_argument("--result_capacity", type=int, default=0, help=(
        "Initial device result-buffer slots (0 = auto: min(max_results, "
        "2^20)); a sweep whose hit count exceeds it re-runs once at the "
        "next pow2 bucket"))
    p.add_argument("--skip_existing", action="store_true", help=(
        "Exit successfully without recomputing when this shard's output "
        "partition already exists (idempotent fan-out restarts)"))
    p.add_argument("--profile_dir", default="", help=(
        "If set, write a torch.profiler Chrome trace of the task, from "
        "metadata to write, with its named spans (CPU, and CUDA on a CUDA "
        "device) into this directory (local or gs://) as "
        "trace-part-NNNNN.json, named after this run's output partition so "
        "that the tasks of a fan-out can share one directory (open it in "
        "Perfetto or chrome://tracing)"))
    p.add_argument("--quiet", action="store_true", help="Suppress stage logs")
    return p


def _check_device(name: str) -> None:
    import torch

    try:
        device = torch.device(name)
    except RuntimeError as e:
        raise InvalidArgumentError(f"Invalid --device {name!r}: {e}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise FailedPreconditionError(
            f"--device {name} needs a CUDA device, and none is available; "
            "pass --device cpu to run the plain PyTorch path on the CPU."
        )


def _resolve_devices(args) -> list[str]:
    """The ``--device`` entries: one device, or under --use_mesh the ring
    positions (default: every visible CUDA device, or with --distributed
    this rank's ``cuda:$LOCAL_RANK``)."""
    import torch

    if args.device:
        names = [d.strip() for d in args.device.split(",")]
    elif not args.use_mesh:
        names = ["cuda"]
    elif args.distributed:
        names = [f"cuda:{os.environ.get('LOCAL_RANK', '0')}"]
    else:
        names = [f"cuda:{k}" for k in range(torch.cuda.device_count())] or ["cuda"]
    if len(names) > 1 and not args.use_mesh:
        raise InvalidArgumentError(
            f"--device {args.device!r} lists {len(names)} devices; a list of "
            "ring positions needs --use_mesh"
        )
    for name in names:
        _check_device(name)
    types = sorted({torch.device(n).type for n in names})
    if len(types) > 1:
        raise InvalidArgumentError(
            f"Ring positions must all be on one device type; --device lists {types}"
        )
    return names


def _multihost_context_reason() -> str | None:
    """A human-readable reason the environment looks like a multi-process
    run (torchrun or a hand-set env:// rendezvous), or None for a plain
    local run."""
    world = os.environ.get("WORLD_SIZE", "")
    if world.isdigit() and int(world) > 1:
        return f"WORLD_SIZE={world}"
    for k in ("MASTER_ADDR", "TORCHELASTIC_RUN_ID"):
        if os.environ.get(k):
            return f"{k} is set"
    return None


def _init_distributed(devices: list[str]) -> bool:
    """Starts torch.distributed from the env:// (torchrun) variables, with
    a rendezvous timeout of its own; NCCL for CUDA positions, gloo for CPU
    ones.  Returns False when the caller had already started it."""
    import torch
    import torch.distributed as dist

    if dist.is_initialized():
        return False
    first = torch.device(devices[0])
    if first.type == "cuda" and first.index is not None:
        torch.cuda.set_device(first)
    store, rank, world = next(dist.rendezvous("env://", timeout=RENDEZVOUS_TIMEOUT))
    dist.init_process_group(
        "nccl" if first.type == "cuda" else "gloo", store=store, rank=rank,
        world_size=world, timeout=COLLECTIVE_TIMEOUT,
    )
    return True


def _start_mesh(args, devices: list[str], logger) -> tuple[RingMesh, bool]:
    """The ring mesh; with --distributed, over every rank's positions.
    Returns (mesh, whether this call started torch.distributed)."""
    if not args.distributed:
        return RingMesh(devices), False
    import torch.distributed as dist

    created = False
    try:
        created = _init_distributed(devices)
    except (ValueError, RuntimeError, OSError) as e:
        # A multi-process run whose rendezvous fails must be fatal:
        # continuing would give every rank rank 0, a local-only ring, a
        # full-cohort bitset per rank and races on part-00000.  Only
        # proceed single-process when nothing in the environment says this
        # is a multi-process run (local dev).
        reason = _multihost_context_reason()
        if reason and not args.allow_single_process:
            raise FailedPreconditionError(
                "torch.distributed failed to initialize in what looks like "
                f"a multi-process run ({reason}); refusing to degrade to "
                "a single-process mesh. Re-run the task, or pass "
                f"--allow_single_process to override. Cause: {e}"
            ) from e
        logger.print(
            "No distributed coordinator available; running single-process."
        )
    if not dist.is_initialized():
        return RingMesh(devices), created
    mesh = RingMesh.from_process_group(devices)
    logger.print(
        f"Initialized distributed runtime: rank {mesh.rank} of "
        f"{dist.get_world_size()}, {mesh.size} ring positions total."
    )
    return mesh, created


def _run_mesh_sweep(args, panel_storage, config: KingConfig, mesh: RingMesh, logger):
    """Ring path: sample-sharded blocks rotating over the mesh
    (parallel/ring.py) instead of the single-device panel sweep.  With
    --distributed each rank extracts only its own positions' hits
    (share-nothing outputs, like the reference's shards, README.md:102).
    The port's kernels take any row count, so the row multiple is 1."""
    logger.print(f"Using a {mesh.size}-position mesh for the ring sweep.")
    common = dict(
        kin_threshold=args.kin_threshold,
        capacity_per_device=args.capacity_per_device
        or default_capacity_per_device(args.max_results, mesh.size),
        max_results=args.max_results,
        sub_panel=config.panel,
        indexed_kernel=resolve_indexed_kernel(config),
    )
    kernel = resolve_kernel(config)
    if isinstance(panel_storage, HostShardedStorage):
        # Each rank holds only its own positions' blocks of this shard's
        # range(s); no rank holds the whole cohort.
        arrays = panel_storage.to_device_blocks()
        if len(arrays) == 1:
            begin, length = panel_storage.ranges[0]
            out = all_pairs_presharded(
                arrays[0], length, mesh, kernel, row_offset=begin, **common
            )
        else:
            (i_begin, i_count), (j_begin, j_count) = panel_storage.ranges
            out = rect_pairs_presharded(
                arrays[0], arrays[1], i_count, j_count, mesh, kernel,
                i_offset=i_begin, j_offset=j_begin, **common,
            )
    else:
        # A diagonal shard runs the triangular ring at its global row
        # offset, an off-diagonal shard the rectangular ring.
        out = submatrix_pairs_sharded(panel_storage, mesh, kernel, **common)
    if args.distributed:
        return ring_output_local_resultset(out, args.max_results)
    return ring_output_to_resultset(out, args.max_results)


def _check_mesh_fit(args, mesh: RingMesh, metadata, layout, submatrix, panel) -> None:
    """The ring's capacity model, before ingest: on overflow the error names
    the minimal --split_factor that fits.  HostShardedStorage pads rows only
    to the row multiple (panel 1); PanelStorage to a panel multiple first."""
    capacity = args.capacity_per_device or default_capacity_per_device(
        args.max_results, mesh.size
    )
    local = [mesh.devices[p] for p in mesh.local_positions]
    limits = [x for x in map(device_bytes_limit, set(local)) if x is not None]
    check_ring_fit(
        metadata.num_samples, layout.words, 0, capacity, mesh.size,
        min(limits) if limits else None,
        submatrix=submatrix,
        panel=1 if args.distributed else panel,
        split_factor=args.split_factor,
        max_results=args.max_results,
        positions_per_device=max(local.count(d) for d in local),
    )


@contextlib.contextmanager
def _profiling(args, storage: Storage, devices: list[str], shard_index: int, logger):
    """With ``--profile_dir``, profiles the body and writes its Chrome trace
    through ``storage`` (so a gs:// directory works); otherwise a no-op.
    Every span the body recorded is added as a complete event
    (``utils/stopwatch.chrome_events``), with its ids and counts: the
    profiler keeps those of its own thread as annotations without them, and
    drops those of other threads (ingest's)."""
    if not args.profile_dir:
        yield
        return
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(devices[0]).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        since = now_ns()
        yield
    spans = [s for s in recorded() if s.start_ns >= since]
    # Named after the output partition: part-00003.snappy.parquet →
    # trace-part-00003.json.
    stem = partition_name(shard_index).split(".")[0]
    uri = storage.join(args.profile_dir, f"trace-{stem}.json")
    # export_chrome_trace writes a local file only.
    with tempfile.TemporaryDirectory() as tmp:
        local = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(local)
        with storage.open_write(uri) as dst:
            append_events(local, dst,
                          lambda base: chrome_events(spans, base, os.getpid()))
    logger.print(f"Wrote profiler trace {uri}.")


def run(args: argparse.Namespace) -> None:
    # Flag validation, mirroring cuking.cu:436-465.
    if not args.input_uri:
        raise InvalidArgumentError("No input URI specified")
    if not args.output_uri:
        raise InvalidArgumentError("No output URI specified")
    if args.num_reader_threads <= 0:
        raise InvalidArgumentError("Invalid number of reader threads")
    if args.split_factor <= 0:
        raise InvalidArgumentError("Invalid split factor")
    if args.shard_index >= num_shards(args.split_factor) or args.shard_index < 0:
        raise InvalidArgumentError("Invalid shard index")
    if args.keep_all:
        if args.kin_threshold is not None:
            raise InvalidArgumentError(
                "--keep_all writes every pair and takes no --kin_threshold")
        if args.use_mesh or args.distributed:
            raise InvalidArgumentError(
                "--keep_all runs on one device; the ring (--use_mesh, "
                "--distributed) does not take it")
    if args.kin_threshold is None:
        args.kin_threshold = DEFAULT_KIN_THRESHOLD
    if args.distributed:
        args.use_mesh = True
    devices = _resolve_devices(args)

    logger = StageLogger(enabled=not args.quiet)
    mesh, created = _start_mesh(args, devices, logger) if args.use_mesh else (None, False)
    try:
        _run_pipeline(args, devices, mesh, logger)
    finally:
        if created:
            import torch.distributed as dist

            dist.destroy_process_group()


def _run_pipeline(args, devices: list[str], mesh: RingMesh | None, logger) -> None:
    storage = Storage(requester_pays_project=args.requester_pays_project)
    shard_index = args.shard_index
    if mesh is not None and mesh.distributed:
        # Each rank owns one disjoint output partition.  With
        # --split_factor the partition index combines (shard, rank), so the
        # merged output keeps the reference's trivially-mergeable property
        # (README.md:102).
        import torch.distributed as dist

        shard_index = args.shard_index * dist.get_world_size() + mesh.rank

    if args.skip_existing:
        part_uri = storage.join(args.output_uri, partition_name(shard_index))
        # Existence alone is not enough: a crashed writer can leave a
        # truncated partition.  Only a partition whose Parquet footer parses
        # counts as done (README.md:102).
        mine_exists = partition_is_valid(storage, part_uri)
        if args.distributed:
            # The skip decision must be COLLECTIVE: a rank that returned
            # early would leave its peers waiting in the ring's first
            # rotation.  Skip only when every rank's partition exists.
            if mesh.all_reduce([int(mine_exists)], op="min")[0]:
                logger.print("All output partitions exist; skipping.")
                return
        elif mine_exists:
            logger.print(f"Output {part_uri} already exists; skipping.")
            return

    with (_profiling(args, storage, devices, shard_index, logger),
          span("cli.task", shard_index=shard_index)):
        _run_stages(args, storage, shard_index, devices, mesh, logger)


def _run_stages(args, storage: Storage, shard_index: int, devices: list[str],
                mesh: RingMesh | None, logger) -> None:
    """The task's stages, from metadata to write, each a ``stage.<key>``
    span under the task's ``cli.task``."""
    import torch

    logger.begin("Reading metadata...", "metadata")
    metadata = read_metadata(storage, args.input_uri)
    logger.end()

    submatrix = Submatrix.create(
        metadata.num_samples, args.split_factor, args.shard_index
    )
    # Small cohorts don't need the full default panel: shrink to the
    # smallest power of two covering the shard (at least 128) so padding
    # work doesn't dominate.
    shard_n = max(submatrix.num_rows, submatrix.num_cols, 1)
    panel = min(args.panel, max(128, ceil_pow2(shard_n)))
    config = KingConfig(
        kin_threshold=args.kin_threshold,
        max_results=args.max_results,
        panel=panel,
        kernel=args.kernel,
        result_capacity=args.result_capacity,
        device=devices[0],
        verbose=not args.quiet,
        keep_all=args.keep_all,
    )
    resolve_kernel_name(config)  # --kernel cuda on a CPU device fails here
    if config.keep_all:
        keep_all_slots(submatrix, config.max_results)  # before any allocation

    layout = PlaneLayout.create(metadata.num_sites)
    # Capacity model: fail up front with the minimal --split_factor that
    # fits instead of a device out-of-memory error mid-upload (the
    # reference's split_factor memory-relief prescription, cuking.cu:513-517).
    if mesh is not None:
        _check_mesh_fit(args, mesh, metadata, layout, submatrix, panel)
    else:
        check_engine_fit(
            metadata.num_samples, layout.words, submatrix, config, args.split_factor
        )
    logger.begin("Allocating bit planes...", "allocate")
    if args.distributed:
        # Host-sharded storage: this rank holds only its own positions'
        # sample row blocks (no full-cohort bitset per rank).
        panel_storage = HostShardedStorage(
            layout, metadata.num_samples, mesh, submatrix=submatrix
        )
    elif mesh is None and torch.device(config.device).type == "cuda":
        # One engine on a card: the planes are built there by ingest's
        # scatter, and the host holds none (ops/king_scatter.py).
        panel_storage = PanelStorage(layout, submatrix, config.panel, device=config.device)
    else:
        # The ring hands host panel blocks between positions; on a CPU
        # device the host planes are the device's.
        panel_storage = PanelStorage(layout, submatrix, config.panel)
    logger.end()
    planes = panel_storage.planes
    mib = planes.nbytes >> 20
    where = planes.device if isinstance(planes, torch.Tensor) else "the host"
    logger.print(f"Allocated {mib} MiB of memory for bit planes on {where}.")

    logger.begin("Listing input files...", "listing")
    input_files = storage.list_parquet_files(args.input_uri)
    logger.end()
    if not input_files:
        raise FailedPreconditionError("No input files found")
    logger.print(f"Found {len(input_files)} input files.")

    logger.begin("Processing Parquet tables...", "ingest")
    ingest_parquet(
        storage,
        input_files,
        panel_storage,
        num_reader_threads=args.num_reader_threads,
        logger=logger,
    )
    logger.end()

    if mesh is not None:
        logger.begin("Running mesh ring sweep...", "king_kernel")
        results = _run_mesh_sweep(args, panel_storage, config, mesh, logger)
        logger.end()
    else:
        engine = KingEngine(panel_storage, config, logger=logger)
        results = engine.run()

    logger.begin(f"Writing {len(results)} results...", "write")
    uri = write_results(
        storage, args.output_uri, results, metadata.samples, shard_index
    )
    logger.end()
    logger.print(f"Wrote {uri}.")


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        run(args)
    except CukingError as e:
        print(f"\nError: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
