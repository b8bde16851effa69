"""Port of ``cuking_tpu/io/parquet_ingest.py`` (a copy; pyarrow is
imported inside the functions).  Two divergences, both in how many threads
run: the decode pool is sized by the CPUs this process may run on
(``native.packer.usable_cpus``, its affinity mask), where the JAX package's
copy counts every core of the host, so a task confined by ``taskset`` or a
container's cpuset starts no more decoders than it has cores; and each
native packer call gets the CPUs that the busy decoders leave (one when
every decoder has a file), where the JAX package's starts up to 16 threads
in every call.

Parquet COO ingest → packed bit planes (the MatrixTable transpose).

The reference reads every ``*.parquet`` blob into memory on a 36-thread pool,
batch-decodes the three columns, and scatters atomic bit-clears into the
shared unified-memory bitset (cuking.cu:526-711).  Here each worker thread
whole-reads a file, decodes it with Arrow's native C++ reader (pyarrow), and
scatters vectorized bit-clears into the shared numpy plane array — either via
the bincount OR-accumulation (bitset.clear_bits_coo) under a lock, or via the
lock-free atomic C++ packer (native/packer.cpp) when built.

Schema contract (enforced like cuking.cu:585-671): exactly 3 columns, by
position: row_idx INT64 (site), col_idx INT64 (sample), n_alt_alleles INT32.
Column NAMES are not checked, matching the reference.

Spans (``utils/stopwatch.py``): per file ``ingest.read`` (the whole read,
``bytes``) on a reader thread, and ``ingest.decode`` (``entries``),
``ingest.filter`` (``kept``) and ``ingest.scatter`` on a decode thread,
each under the span open where ``ingest_parquet`` was called (the CLI's
``stage.ingest``), and recorded when that one is.
"""

from __future__ import annotations

import io
import threading
from concurrent.futures import ThreadPoolExecutor

from cuking_tpu_torch.io.uri import Storage
from cuking_tpu_torch.native.packer import usable_cpus
from cuking_tpu_torch.ops import bitset
from cuking_tpu_torch.utils.status import FailedPreconditionError
from cuking_tpu_torch.utils.stopwatch import StageLogger, current, span


def _decode_file(buf: bytes, source: str):
    """One Parquet blob → (row_idx, col_idx, n_alt_alleles) numpy arrays,
    with the reference's positional schema checks (cuking.cu:585-671)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    expected_types = (pa.int64(), pa.int64(), pa.int32())
    try:
        table = pq.read_table(io.BytesIO(buf))
    except Exception as e:  # pyarrow raises various ArrowInvalid subclasses
        raise FailedPreconditionError(f"Error reading {source}: {e}")
    if table.num_columns != 3:
        raise FailedPreconditionError(
            f"Expected 3 columns, found {table.num_columns} in {source}"
        )
    cols = []
    for idx, expected in enumerate(expected_types):
        col = table.column(idx)
        if col.type != expected:
            raise FailedPreconditionError(
                f"Expected {expected} type, found {col.type} in {source}"
            )
        if col.null_count:
            # to_numpy would silently convert a nullable int column to
            # float64 with NaN, which passes the n_alt range check and packs
            # as hom-ref — a null must be a hard error, matching the
            # reference's value-level validation posture (cuking.cu:698-701).
            raise FailedPreconditionError(
                f"Null value in column {idx} in {source}"
            )
        cols.append(col.to_numpy(zero_copy_only=False))
    return cols[0], cols[1], cols[2]


def ingest_parquet(
    storage: Storage,
    input_files: list[str],
    panel_storage: PanelStorage,
    *,
    num_reader_threads: int = 36,
    logger: StageLogger | None = None,
    use_native: bool | None = None,
) -> None:
    """Populates ``panel_storage.planes`` from the input files in parallel.

    Mirrors the ParallelFor ingest loop (cuking.cu:547-711): per file, read →
    decode → drop samples outside this shard's Submatrix → scatter bit-clears
    keyed by n_alt_alleles.  Raises on the first error, like ParallelFor's
    single-error propagation (cuking.cu:415-433).
    """
    logger = logger or StageLogger(enabled=False)
    stage = current()  # the workers' spans' parent, and whether they record
    planes = panel_storage.planes
    layout = panel_storage.layout

    native = None
    if use_native is not False:
        try:
            from cuking_tpu_torch.native import packer as native_packer

            native = native_packer if native_packer.available() else None
        except Exception:
            native = None
        if use_native and native is None:
            raise FailedPreconditionError("Native packer requested but unavailable")

    scatter_lock = threading.Lock()
    progress = {"count": 0}

    def decode_and_scatter(path: str, buf: bytes) -> None:
        with span("ingest.decode", stage) as decode:
            row_idx, col_idx, n_alt = _decode_file(buf, path)
            decode.count(entries=len(n_alt))
        with span("ingest.filter", stage) as filtered:
            # Skip samples not stored here — outside this shard's Submatrix or,
            # for host-sharded storage, on another host (cuking.cu:676-678).
            keep = panel_storage.contains(col_idx)
            row_idx, col_idx, n_alt = row_idx[keep], col_idx[keep], n_alt[keep]
            offsets = panel_storage.storage_offsets(col_idx)
            filtered.count(kept=len(n_alt))
        with span("ingest.scatter", stage):
            if native is not None:
                # Lock-free: relaxed atomic AND per word, safe under concurrent
                # writers exactly like the reference's AtomicClearBit
                # (cuking.cu:316-323).
                native.clear_bits(planes, layout, offsets, row_idx, n_alt, source=path,
                                  num_threads=packer_threads)
            else:
                # The sort/segment mask computation runs on thread-local arrays
                # and needs no lock; only the O(words-touched) in-place scatter
                # mutates the shared planes.  Keeping the critical section that
                # small stops decode threads convoying on one lock (the r3
                # numpy path was 5.6× slower than native largely from this).
                prepared = bitset.prepare_clear_masks(
                    layout, offsets, row_idx, n_alt, source=path
                )
                with scatter_lock:
                    bitset.apply_clear_masks(planes, prepared)
        with scatter_lock:
            progress["count"] += 1
            if progress["count"] % 1024 == 0:
                logger.dot()

    # Two-stage pipeline.  The reference runs one 36-thread pool for a
    # 12-vCPU task because reads are network-bound on GCS (cuking.cu:36-38,
    # cloud_batch_submit.py:50); but decode + scatter are CPU-bound (Arrow
    # releases the GIL yet also runs its own threads), and oversubscribing
    # cores there makes ingest severalfold slower.  So: ``num_reader_threads``
    # whole-object readers feeding a cores-sized decode pool, with in-flight
    # buffers bounded so memory stays at ~2 blobs per decoder.
    cpu_workers = max(1, min(num_reader_threads, usable_cpus()))
    # A packer call takes the CPUs the busy decoders leave: one when every
    # decoder has a file.  Threads inside every call on top of one decoder
    # per CPU were never faster and up to ~10% slower in three A/B runs on
    # the 8 CPUs of an H100 machine (tools/torch_cli_at_scale.py).
    packer_threads = max(1, usable_cpus() // min(cpu_workers, max(1, len(input_files))))
    in_flight = threading.BoundedSemaphore(cpu_workers * 2)
    errors: list[BaseException] = []

    with ThreadPoolExecutor(max_workers=cpu_workers) as decode_pool:

        def read_task(path: str):
            in_flight.acquire()
            try:
                with span("ingest.read", stage) as read:
                    buf = storage.read_bytes(path)
                    read.count(bytes=len(buf))
            except BaseException:
                in_flight.release()
                raise
            return decode_pool.submit(release_after, path, buf)

        def release_after(path: str, buf: bytes) -> None:
            try:
                decode_and_scatter(path, buf)
            finally:
                in_flight.release()

        with ThreadPoolExecutor(max_workers=num_reader_threads) as read_pool:
            read_futures = [read_pool.submit(read_task, p) for p in input_files]
            decode_futures = []
            for fut in read_futures:
                try:
                    decode_futures.append(fut.result())
                except BaseException as e:  # one error propagates
                    errors.append(e)  # (cuking.cu:414-432)
        for fut in decode_futures:
            try:
                fut.result()
            except BaseException as e:
                errors.append(e)
    # Invalidate any device-side cache of the planes (KingEngine.planes_dev)
    # even on partial failure — some blocks may already have been scattered.
    panel_storage.mark_mutated()
    if errors:
        raise errors[0]
