"""Ingest's shard filter in a task cell, in thread-seconds per task: the
``ingest.filter`` spans (each file's entries of the samples this shard
stores picked out, and their storage rows, on a decode thread) summed
over the window's tasks and their threads, over the tasks.  The threads
overlap, so the sum can pass the ingest stage's wall time.  It moves
``task_s``."""

from kingbench.spans import thread_s_per_unit


def read(ctx: dict) -> float | None:
    return thread_s_per_unit(ctx, "ingest.filter")
