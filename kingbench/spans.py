"""The port's spans of a traced window, for the per-layer readers that
read them (``cuking_tpu_torch.utils.stopwatch``).

The port records a span only while a profiler records, and one run of
a cell is one process, so the spans kept are the window's: the warm unit
runs before the profiler starts, the reference after it stops.  A program
that records no spans (one that predates the recorder) reads as None, and
so does a window without the spans a reader needs.
"""

from __future__ import annotations


def recorded(name: str) -> list:
    """The window's closed spans called ``name`` ([] where the program
    records none)."""
    from cuking_tpu_torch.utils import stopwatch

    read = getattr(stopwatch, "recorded", None)
    return [s for s in read() if s.name == name] if read is not None else []


def seconds(spans: list) -> float:
    """Their durations summed, in s."""
    return sum(s.end_ns - s.start_ns for s in spans) / 1e9


def count(spans: list, key: str) -> int:
    """Their counts under ``key`` summed."""
    return sum(s.counts.get(key, 0) for s in spans)


def thread_s_per_unit(ctx: dict, name: str) -> float | None:
    """The spans called ``name`` summed over their threads, in s, per unit
    of the window."""
    spans = recorded(name)
    return seconds(spans) / ctx["units"] if spans and ctx["units"] else None
