"""Port of ``cuking_tpu/interop`` (a copy).

Hail interop: MatrixTable → cuKING input Parquet, output Parquet → Table.

The reference's L6 layer (SURVEY.md §1): mt_to_cuking_inputs.py and
cuking_outputs_to_ht.py.  Hail is an optional dependency — these modules
import it lazily and raise a clear FailedPreconditionError when absent, so
the rest of the framework stays usable without a Spark cluster.
"""
