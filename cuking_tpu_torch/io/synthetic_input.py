"""Port of ``cuking_tpu/io/synthetic_input.py`` (a copy; pyarrow is
imported inside the functions).

Writes cuKING-format input directories from dense genotypes.

Produces exactly what mt_to_cuking_inputs.py produces from a Hail MT
(mt_to_cuking_inputs.py:14-47, README.md:11-31): multiple Parquet partitions
with columns ``row_idx INT64, col_idx INT64, n_alt_alleles INT32`` (missing
entries omitted), plus ``metadata.json`` with ``num_sites`` and the
col_idx-ordered ``samples`` list.  Used by tests, tools, and benchmarks.
"""

from __future__ import annotations

import numpy as np

from cuking_tpu_torch.io.metadata import InputMetadata, write_metadata
from cuking_tpu_torch.io.uri import Storage
from cuking_tpu_torch.utils.synthetic import genotypes_to_coo


def write_synthetic_input(
    storage: Storage,
    input_uri: str,
    genotypes: np.ndarray,
    *,
    sample_ids: list[str] | None = None,
    num_partitions: int = 4,
    compression: str = "zstd",  # the exporter writes ZSTD inputs
    shuffle_seed: int = 0,
) -> InputMetadata:
    import pyarrow as pa
    import pyarrow.parquet as pq

    coo_schema = pa.schema(
        [
            pa.field("row_idx", pa.int64()),
            pa.field("col_idx", pa.int64()),
            pa.field("n_alt_alleles", pa.int32()),
        ]
    )
    num_samples, num_sites = genotypes.shape
    if sample_ids is None:
        sample_ids = [f"S{k:06d}" for k in range(num_samples)]
    row_idx, col_idx, n_alt = genotypes_to_coo(genotypes, seed=shuffle_seed)

    parts = np.array_split(np.arange(len(n_alt)), max(num_partitions, 1))
    for p, sel in enumerate(parts):
        table = pa.Table.from_arrays(
            [
                pa.array(row_idx[sel], type=pa.int64()),
                pa.array(col_idx[sel], type=pa.int64()),
                pa.array(n_alt[sel], type=pa.int32()),
            ],
            schema=coo_schema,
        )
        uri = storage.join(input_uri, f"part-{p:05d}.{compression}.parquet")
        with storage.open_write(uri) as f:
            pq.write_table(table, f, compression=compression)

    metadata = InputMetadata(num_sites=num_sites, samples=list(sample_ids))
    write_metadata(storage, input_uri, metadata)
    return metadata
