"""The engine's copy of the rows to the host in an export cell, in GB/s
(1e9 B): the ``engine.fetch`` spans' ``bytes`` (24 B a row) over their
durations, summed over the window's tasks.  A port whose fetch spans
count no bytes reads None.  It moves ``task_s``."""

from kingbench.spans import count, recorded, seconds


def read(ctx: dict) -> float | None:
    spans = recorded("engine.fetch")
    nbytes, s = count(spans, "bytes"), seconds(spans)
    return nbytes / s / 1e9 if nbytes and s > 0 else None
