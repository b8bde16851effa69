"""Port of ``cuking_tpu/io/writer.py`` (a copy; pyarrow is imported inside
the functions).

Result Parquet writer (cuking.cu:754-879).

Contract: schema ``i: string (required), j: string (required), kin: float32,
ibs0/ibs1/ibs2: int32``; rows sorted by (sample_i, sample_j, kin) for
columnar compression; Snappy (Hail's libhadoop can't read ZSTD,
cuking.cu:796-798); one row group; one partition per shard named
``part-%05d.snappy.parquet`` (cuking.cu:866-875)."""

from __future__ import annotations

import numpy as np

from cuking_tpu_torch.io.uri import Storage
from cuking_tpu_torch.models.king import ResultSet


def result_schema():
    """The partition schema (``RESULT_SCHEMA`` in the JAX package)."""
    import pyarrow as pa

    return pa.schema(
        [
            pa.field("i", pa.string(), nullable=False),
            pa.field("j", pa.string(), nullable=False),
            pa.field("kin", pa.float32(), nullable=False),
            pa.field("ibs0", pa.int32(), nullable=False),
            pa.field("ibs1", pa.int32(), nullable=False),
            pa.field("ibs2", pa.int32(), nullable=False),
        ]
    )


def partition_name(shard_index: int) -> str:
    return f"part-{shard_index:05d}.snappy.parquet"


def partition_is_valid(storage: Storage, uri: str) -> bool:
    """True iff ``uri`` exists and is a structurally complete Parquet file.

    ``--skip_existing`` must not trust a partition on existence alone: a
    previous run killed mid-write (or a non-atomic remote store) can leave a
    truncated object, and skipping it would silently drop that shard's pairs.
    Parquet puts its footer (metadata + magic) last, so a successful
    ``pq.read_metadata`` proves the file was written to completion — the
    validation counterpart of the reference's always-recompute restart
    posture (README.md:102, cuking.cu:866-875).
    """
    import pyarrow.parquet as pq

    if not storage.exists(uri):
        return False
    try:
        with storage.open_read(uri) as f:
            pq.read_metadata(f)
        return True
    except Exception:
        return False


def results_to_table(results: ResultSet, sample_ids: list[str]):
    """Numeric sample indices → ID strings through the metadata ordering
    (cuking.cu:811-824); returns a ``pyarrow.Table``."""
    import pyarrow as pa

    ids = np.asarray(sample_ids, dtype=object)
    return pa.Table.from_arrays(
        [
            pa.array(ids[results.i_idx], type=pa.string()),
            pa.array(ids[results.j_idx], type=pa.string()),
            pa.array(results.kin, type=pa.float32()),
            pa.array(results.ibs0, type=pa.int32()),
            pa.array(results.ibs1, type=pa.int32()),
            pa.array(results.ibs2, type=pa.int32()),
        ],
        schema=result_schema(),
    )


def write_results(
    storage: Storage,
    output_uri: str,
    results: ResultSet,
    sample_ids: list[str],
    shard_index: int,
) -> str:
    """Writes one sorted Snappy Parquet partition; returns its URI."""
    import pyarrow.parquet as pq

    table = results_to_table(results, sample_ids)
    uri = storage.join(output_uri, partition_name(shard_index))
    with storage.open_write(uri) as f:
        pq.write_table(
            table,
            f,
            compression="snappy",
            row_group_size=max(len(results), 1),
            use_dictionary=False,
        )
    return uri


def read_results_table(storage: Storage, output_uri: str):
    """Reads all ``part-*.snappy.parquet`` partitions back into one
    ``pyarrow.Table`` — the non-Hail twin of cuking_outputs_to_ht.py for local
    verification."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    tables = []
    for f in storage.list_parquet_files(output_uri):
        with storage.open_read(f) as fh:
            tables.append(pq.read_table(fh))
    if not tables:
        return result_schema().empty_table()
    return pa.concat_tables(tables)
