"""The writer's rate in an export cell, in rows per s: the rows of the
``writer.parquet`` spans (each partition's rows) over the summed seconds of
the ``writer.table`` spans (sample IDs mapped, Arrow arrays built) and the
``writer.parquet`` spans (the Snappy Parquet written and committed), over
the window's tasks.  A port without these spans reads None.  It moves
``task_s``."""

from kingbench.spans import count, recorded, seconds


def read(ctx: dict) -> float | None:
    table, parquet = recorded("writer.table"), recorded("writer.parquet")
    rows, s = count(parquet, "rows"), seconds(table) + seconds(parquet)
    return rows / s if rows and table and s > 0 else None
