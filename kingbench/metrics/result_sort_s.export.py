"""The engine's host sort of the rows (``engine.sort`` spans,
``ResultSet.concat_and_sort``: a lexsort by (i, j, kin) and the six
columns gathered) in an export cell, in s per task.  It moves ``task_s``."""

from kingbench.spans import recorded, seconds


def read(ctx: dict) -> float | None:
    spans = recorded("engine.sort")
    return seconds(spans) / ctx["units"] if spans and ctx["units"] else None
