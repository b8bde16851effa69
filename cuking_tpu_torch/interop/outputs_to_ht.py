"""Port of ``cuking_tpu/interop/outputs_to_ht.py`` (a copy; Hail is imported
inside the functions).

cuKING output Parquet → keyed Hail Table (C15).

Mirror of the reference's cuking_outputs_to_ht.py:11-16: Spark-read every
``part-*.snappy.parquet`` partition under the output directory, convert to a
Hail Table, key by ``(i, j)`` so downstream steps (e.g.
``hl.maximal_independent_set``) can join on the pair.

Run on a Dataproc/Spark cluster with Hail installed::

    python -m cuking_tpu_torch.interop.outputs_to_ht \
        --parquet-uri gs://bucket/out.parquet \
        --ht-uri gs://bucket/relatedness.ht

For Hail-free local verification use
``cuking_tpu_torch.io.writer.read_results_table`` (same partitions, pyarrow).
"""

from __future__ import annotations

import argparse

from cuking_tpu_torch.utils.status import FailedPreconditionError


def _require_hail():
    try:
        import hail as hl  # noqa: PLC0415
    except ImportError as e:
        raise FailedPreconditionError(
            "cuking_outputs_to_ht requires Hail (run on a Dataproc/Spark "
            f"cluster with hail installed): {e}"
        )
    return hl


def cuking_outputs_to_ht(parquet_uri: str):
    """Reads all output partitions into one Hail Table keyed by (i, j)."""
    hl = _require_hail()
    spark = hl.utils.java.Env.spark_session()
    df = spark.read.parquet(f"{parquet_uri}/*.parquet")
    ht = hl.Table.from_spark(df)
    return ht.key_by(ht.i, ht.j)


def main(argv: list[str] | None = None) -> int:
    # Flag names match the reference script (cuking_outputs_to_ht.py:18-34)
    # so existing pipelines swap in without changes.
    parser = argparse.ArgumentParser(
        description="Convert cuking_tpu_torch output Parquet to a Hail Table."
    )
    parser.add_argument(
        "--parquet-uri", required=True,
        help="Input URI for the Parquet files",
    )
    parser.add_argument(
        "--ht-uri", required=True, help="Output URI for the Hail table",
    )
    parser.add_argument(
        "--overwrite", action="store_true", help="Overwrite output files",
    )
    args = parser.parse_args(argv)

    hl = _require_hail()
    hl.init(default_reference="GRCh38")
    ht = cuking_outputs_to_ht(args.parquet_uri)
    ht.write(args.ht_uri, overwrite=args.overwrite)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
