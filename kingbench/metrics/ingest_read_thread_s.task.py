"""Ingest's reads in a task cell, in thread-seconds per task: the
``ingest.read`` spans (each input file's whole read, ``storage.read_bytes``,
on a reader thread) summed over the window's tasks and their threads,
over the tasks.  The threads overlap, so the sum can pass the ingest
stage's wall time.  It moves ``task_s``."""

from kingbench.spans import thread_s_per_unit


def read(ctx: dict) -> float | None:
    return thread_s_per_unit(ctx, "ingest.read")
