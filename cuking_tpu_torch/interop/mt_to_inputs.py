"""Port of ``cuking_tpu/interop/mt_to_inputs.py`` (a copy; Hail is imported
inside the functions).

Hail MatrixTable → cuKING input Parquet + metadata.json (C14).

The port consumes the exact same input contract as the reference
(mt_to_cuking_inputs.py:14-47): a directory of Parquet partitions with
columns ``row_idx INT64, col_idx INT64, n_alt_alleles INT32`` — one row per
*present* genotype (missing entries simply not written — the table is
sparse), ZSTD-compressed by Spark — plus ``metadata.json`` holding
``num_sites`` and the col_idx-ordered ``samples`` list.

Run on a Dataproc/Spark cluster with Hail installed::

    python -m cuking_tpu_torch.interop.mt_to_inputs \
        --mt-uri gs://bucket/cohort.mt \
        --parquet-uri gs://bucket/cohort.parquet

Without Hail installed, importing this module is fine; calling it raises
FailedPreconditionError.  For local/synthetic inputs use
``cuking_tpu_torch.io.synthetic_input.write_synthetic_input`` instead (same
schema, no Spark needed).
"""

from __future__ import annotations

import argparse
import json

from cuking_tpu_torch.utils.status import FailedPreconditionError


def _require_hail():
    try:
        import hail as hl  # noqa: PLC0415
    except ImportError as e:
        raise FailedPreconditionError(
            "mt_to_cuking_inputs requires Hail (run on a Dataproc/Spark "
            f"cluster with hail installed): {e}"
        )
    return hl


def mt_to_cuking_inputs(mt, parquet_uri: str, overwrite: bool = False) -> None:
    """Converts a Hail MatrixTable to the cuKING input Parquet format.

    Mirrors the reference transformation pipeline exactly
    (mt_to_cuking_inputs.py:14-47): keep only ``n_alt_alleles`` per entry,
    drop all globals/row/col fields, index rows and columns densely, export
    the entries table via Spark as ZSTD Parquet, then write metadata.json
    with the col_idx-ordered sample IDs.
    """
    hl = _require_hail()

    mt = mt.select_entries(n_alt_alleles=mt.GT.n_alt_alleles())
    mt = mt.select_globals().select_rows().select_cols()
    mt = mt.add_row_index()
    mt = mt.add_col_index()
    entries = mt.entries()
    entries = entries.key_by()
    entries = entries.select(
        row_idx=entries.row_idx, col_idx=entries.col_idx,
        n_alt_alleles=entries.n_alt_alleles,
    )
    # Spark writes one ZSTD Parquet file per partition; missing genotypes
    # were never materialized as entries, so the output is sparse.
    entries.to_spark().write.option("compression", "zstd").parquet(
        parquet_uri, mode="overwrite" if overwrite else "errorifexists"
    )

    # metadata.json: list position == col_idx (cuking.cu:488-494 relies on it).
    cols = mt.key_cols_by().cols()
    sample_ids = [
        row.s
        for row in sorted(
            cols.select(cols.col_idx, cols.s).collect(),
            key=lambda row: row.col_idx,
        )
    ]
    metadata = {"num_sites": mt.count_rows(), "samples": sample_ids}
    with hl.hadoop_open(f"{parquet_uri}/metadata.json", "w") as f:
        json.dump(metadata, f)


def main(argv: list[str] | None = None) -> int:
    # Flag names match the reference script (mt_to_cuking_inputs.py:49-65)
    # so existing pipelines swap in without changes.
    parser = argparse.ArgumentParser(
        description="Convert a Hail MatrixTable to cuKING input Parquet."
    )
    parser.add_argument(
        "--mt-uri", required=True, help="Input URI for the Hail MT",
    )
    parser.add_argument(
        "--parquet-uri", required=True,
        help="Output URI for the Parquet files",
    )
    parser.add_argument(
        "--overwrite", action="store_true", help="Overwrite output files",
    )
    args = parser.parse_args(argv)

    hl = _require_hail()
    hl.init(default_reference="GRCh38")
    mt = hl.read_matrix_table(args.mt_uri)
    mt_to_cuking_inputs(mt, args.parquet_uri, args.overwrite)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
