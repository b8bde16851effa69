"""The traced window: ``torch.profiler`` around the units of a window, the
trace read once, and the device's idle gaps labelled by what the host was
doing.

Each unit runs under a ``record_function`` annotation (``kingbench.unit``),
which the trace keeps on the host's timeline; its start there against the
host clock read at the same moment maps host times onto the trace.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile

from kingbench.frozen import trace as frozen_trace

UNIT = "kingbench.unit"
TOP = 10


@contextlib.contextmanager
def profiled(enabled: bool, cuda: bool):
    """Yields a dict that, when the body ends, holds the parsed trace under
    ``"trace"`` (nothing when ``enabled`` is false)."""
    if not enabled:
        yield {}
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out: dict = {}
    with profile(activities=activities) as prof:
        yield out
    with tempfile.TemporaryDirectory(prefix="kingbench-trace-") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            out["trace"] = json.load(f)


def unit_marker():
    """The annotation around one unit."""
    from torch.profiler import record_function

    return record_function(UNIT)


def host_spans(trace: dict, name: str = UNIT) -> list[tuple[float, float]]:
    """(start, end) in us of the host annotations called ``name``."""
    return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                  for e in trace.get("traceEvents", [])
                  if e.get("ph") == "X" and e.get("name") == name
                  and e.get("cat", "").lower() == "user_annotation")


def device_ops(events) -> list:
    """[name, seconds] of the device operations that took most time,
    summed by name."""
    by_name: dict = {}
    for e in events:
        key = e.name[:96]
        by_name[key] = by_name.get(key, 0.0) + (e.end - e.start) / 1e6
    return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]


def idle_gaps(events, window: tuple[float, float], label) -> list:
    """[label, seconds] of the longest stretches of the traced window in
    which no device operation ran on any card, ``label(t_us)`` naming what
    the host was doing at a gap's middle."""
    busy = frozen_trace._merged((e.start, e.end) for e in events)
    edges = [window[0]] + [x for s, e in busy for x in (s, e)] + [window[1]]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2)
            if edges[k + 1] > edges[k]]
    gaps.sort(key=lambda g: g[0] - g[1])
    return [[label((s + e) / 2), (e - s) / 1e6] for s, e in gaps[:TOP]]


def read_window(trace: dict) -> tuple[dict, list, tuple[float, float] | None]:
    """(the frozen ``analyze``'s reading, the device events, the traced
    window in us)."""
    events, _, window = frozen_trace.read(trace)
    return frozen_trace.analyze(trace), events, window


def mean_busy_ms(stats: dict, chips: int) -> float:
    """A card's mean busy time in the traced window, in ms: the frozen
    ``analyze``'s busy union, which sums each card's, over the cell's
    ``chips`` cards, so that a card with no device events counts as idle.
    (For one card, a division by 1.0, which returns the union exactly.)"""
    return stats["busy_union_ms"] / chips


def idle_share(ctx: dict) -> float | None:
    """A card's mean share (%) of the traced window in which it ran no
    device operation: 1 - its mean busy time over the window's span; None
    without device events."""
    t = ctx["trace"]
    if not t["device_events"] or not t["trace_span_ms"]:
        return None
    return 100 * (1 - mean_busy_ms(t, ctx["chips"]) / t["trace_span_ms"])
