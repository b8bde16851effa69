"""Ingest's rate in a task cell: the input's entries, every one of which a
task reads, over the CLI's "Processing Parquet tables..." stage, summed
over the window's tasks.  It moves ``task_s``."""


def read(ctx: dict) -> float | None:
    seconds = sum(s["ingest"] for s in ctx["stages"])
    return ctx["entries"] * len(ctx["stages"]) / seconds if seconds else None
