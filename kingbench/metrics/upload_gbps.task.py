"""The engine's plane upload in a task cell, in GB/s (1e9 B): the
``engine.upload`` spans' bytes over their durations, summed over the
window's tasks.  On a card it is the host-to-device copy of the planes
from pageable memory.  It moves ``task_s``."""

from kingbench.spans import count, recorded, seconds


def read(ctx: dict) -> float | None:
    spans = recorded("engine.upload")
    s = seconds(spans)
    return count(spans, "bytes") / s / 1e9 if spans and s > 0 else None
