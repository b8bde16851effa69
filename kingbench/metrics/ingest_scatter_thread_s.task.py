"""Ingest's scatter in a task cell, in thread-seconds per task: the
``ingest.scatter`` spans (each file's bit clears into the planes, on a
decode thread: on one card's planes the checks, packing and enqueued
copies and launches of the scatter kernel; on host planes the native
packer or the numpy path with its lock) summed over the window's tasks
and their threads, over the tasks.  The threads
overlap, so the sum can pass the ingest stage's wall time.  It moves
``task_s``."""

from kingbench.spans import thread_s_per_unit


def read(ctx: dict) -> float | None:
    return thread_s_per_unit(ctx, "ingest.scatter")
