"""Port of ``cuking_tpu/cli.py``: the single-device end-to-end pipeline
(reference: cuking.cu:435-895).

Same eight flags as the reference binary (cuking.cu:27-52), same validation,
same stages: read metadata → build shard Submatrix → allocate planes →
list+ingest Parquet in parallel → all-pairs KING (the panel sweep on
``--device``) → overflow check → sort → write one Snappy Parquet partition
per shard.

``--device`` (default ``cuda``) names the torch device.  Without a CUDA
device the default fails with exit code 1; ``--device cpu`` runs the plain
PyTorch count path.  The TPU package's multi-chip flags (``--use_mesh``,
``--distributed``, ``--allow_single_process``, ``--capacity_per_device``)
and its ``--profile_dir``, ``--indexed_panels`` and ``--tile_i/--tile_j``
are not ported yet.

Usage::

    python -m cuking_tpu_torch.cli --input_uri gs://bucket/in.parquet \
        --output_uri gs://bucket/out.parquet --kin_threshold 0.0884 \
        --split_factor 4 --shard_index 3
"""

from __future__ import annotations

import argparse
import sys

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
    resolve_kernel_name,
)
from cuking_tpu_torch.ops.bitset import PlaneLayout
from cuking_tpu_torch.ops.compaction import ceil_pow2
from cuking_tpu_torch.parallel.submatrix import Submatrix, num_shards
from cuking_tpu_torch.utils.hbm import check_engine_fit
from cuking_tpu_torch.utils.status import (
    CukingError,
    FailedPreconditionError,
    InvalidArgumentError,
)
from cuking_tpu_torch.utils.stopwatch import StageLogger


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
    p.add_argument("--kin_threshold", type=float, default=DEFAULT_KIN_THRESHOLD,
                   help=("Only store kinship coefficients strictly larger than "
                         "this threshold (default: 2nd degree or closer)"))
    p.add_argument("--split_factor", type=int, default=1, help=(
        "Split the relatedness matrix into k x k submatrices for sharding"))
    p.add_argument("--shard_index", type=int, default=0, help=(
        "Shard index in [0, split_factor*(split_factor+1)/2)"))
    # Extensions (no reference counterpart):
    p.add_argument("--kernel", default="auto", choices=list(KERNELS),
                   help=("Count kernel: the CUDA kernel, or the plain PyTorch "
                         "int8 product (auto: cuda on a CUDA device)"))
    p.add_argument("--device", default="cuda", help=(
        "Torch device for the sweep (default cuda; cpu runs the plain "
        "PyTorch path)"))
    p.add_argument("--panel", type=int, default=1024,
                   help="Samples per panel (pair-tile edge) in the sweep")
    p.add_argument("--result_capacity", type=int, default=0, help=(
        "Initial device result-buffer slots (0 = auto: min(max_results, "
        "2^20)); the buffer grows to the next pow2 bucket when a sweep "
        "needs more"))
    p.add_argument("--skip_existing", action="store_true", help=(
        "Exit successfully without recomputing when this shard's output "
        "partition already exists (idempotent fan-out restarts)"))
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
    _check_device(args.device)

    logger = StageLogger(enabled=not args.quiet)
    storage = Storage(requester_pays_project=args.requester_pays_project)

    if args.skip_existing:
        part_uri = storage.join(args.output_uri, partition_name(args.shard_index))
        # Existence alone is not enough: a crashed writer can leave a
        # truncated partition.  Only a partition whose Parquet footer parses
        # counts as done (README.md:102).
        if partition_is_valid(storage, part_uri):
            logger.print(f"Output {part_uri} already exists; skipping.")
            return

    logger.begin("Reading metadata...")
    metadata = read_metadata(storage, args.input_uri)
    logger.end("metadata")

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
        device=args.device,
        verbose=not args.quiet,
    )
    resolve_kernel_name(config)  # --kernel cuda on a CPU device fails here

    layout = PlaneLayout.create(metadata.num_sites)
    # Capacity model: fail up front with the minimal --split_factor that
    # fits instead of a device out-of-memory error mid-upload (the
    # reference's split_factor memory-relief prescription, cuking.cu:513-517).
    check_engine_fit(
        metadata.num_samples, layout.words, submatrix, config, args.split_factor
    )
    panel_storage = PanelStorage(layout, submatrix, config.panel)
    mib = panel_storage.planes.nbytes >> 20
    logger.print(f"Allocated {mib} MiB of memory for bit planes.")

    logger.begin("Listing input files...")
    input_files = storage.list_parquet_files(args.input_uri)
    logger.end("listing")
    if not input_files:
        raise FailedPreconditionError("No input files found")
    logger.print(f"Found {len(input_files)} input files.")

    logger.begin("Processing Parquet tables...")
    ingest_parquet(
        storage,
        input_files,
        panel_storage,
        num_reader_threads=args.num_reader_threads,
        logger=logger,
    )
    logger.end("ingest")

    engine = KingEngine(panel_storage, config, logger=logger)
    results = engine.run()

    logger.begin(f"Writing {len(results)} results...")
    uri = write_results(
        storage, args.output_uri, results, metadata.samples, args.shard_index
    )
    logger.end("write")
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
