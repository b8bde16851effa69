"""Frozen copy of ``cuking_tpu_torch/utils/trace.py`` as of commit a4f2d36:
where the device's time went, read from a ``torch.profiler`` Chrome trace.

Adapted: :func:`read` and :func:`analyze` also take the trace already
parsed, so that a window's trace is parsed once; ``intervals_per_card``,
``report`` and ``traced`` are not copied (``kingbench/tracing.py``
profiles the window).

Device activity is the complete (``"ph": "X"``) events of three
categories, ``kernel``, ``gpu_memcpy`` and ``gpu_memset``; each names its
card (``args.device``) and stream (``args.stream``).  CUDA device
activities do not nest, so nothing here is skipped; the annotations that
the profiler draws on the device's timeline (``gpu_user_annotation``) span
other events and are not device activity.  A trace of a CPU run has no
device events, and reads as zero device time.  Times in a trace are
microseconds; every ``*_ms`` value here is in milliseconds.
"""

from __future__ import annotations

import collections
import json
import re
from typing import NamedTuple

COUNT_KERNEL = "count kernel"
EMIT_KERNEL = "emit kernel"
PEER = "peer copy / NCCL"
MEMSET = "memset"
OTHER_KERNELS = "other kernels"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# The kernels' names in a trace, by the names of their launch counters
# (``king_cuda.launches``, ``king_emit.emit_launches``).  The AND + popcount
# yardstick (``king_counts_popc_kernel``) is a count kernel too, but its
# launches are counted apart.
LAUNCH_NAMES = {"king_counts": "king_counts_wgmma_kernel", "king_emit": "king_emit_kernel"}


class DeviceEvent(NamedTuple):
    name: str
    cat: str        # the trace's category: kernel, gpu_memcpy or gpu_memset
    category: str   # :func:`classify`'s
    card: int
    stream: int
    start: float    # us
    end: float


def classify(name: str, cat: str) -> str | None:
    """The category of one trace event, or None when it is no device
    activity: the two kernels of the port by name, then peer copies and
    NCCL kernels, other copies by direction (``memcpy HtoD``, ``memcpy
    DtoH``, ``memcpy DtoD``), memsets, and every other kernel (PyTorch's
    own)."""
    cat = cat.lower()
    if cat not in DEVICE_CATS:
        return None
    if "king_counts" in name:
        return COUNT_KERNEL
    if "king_emit" in name:
        return EMIT_KERNEL
    if "Memcpy PtoP" in name or name.startswith("nccl"):
        return PEER
    if cat == "gpu_memcpy":
        m = re.match(r"Memcpy (\w+)", name)
        return f"memcpy {m.group(1)}" if m else "memcpy"
    if cat == "gpu_memset":
        return MEMSET
    return OTHER_KERNELS


def read(path) -> tuple[list[DeviceEvent], dict, tuple[float, float] | None]:
    """(the device events of the trace at ``path`` (or of the trace
    already parsed, a dict) in time order, the card names its
    ``deviceProperties`` give by card, the (first start, last end) in us of
    all its events, host ones included, or None for an empty trace)."""
    if isinstance(path, dict):
        trace = path
    else:
        with open(path) as f:
            trace = json.load(f)
    events, window = [], None
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        start = float(e["ts"])
        end = start + float(e.get("dur", 0))
        window = (start, end) if window is None else (min(window[0], start),
                                                      max(window[1], end))
        name = e.get("name", "")
        category = classify(name, e.get("cat", ""))
        if category is None:
            continue
        args = e.get("args", {})
        events.append(DeviceEvent(name, e["cat"].lower(), category,
                                  int(args.get("device", e.get("pid", 0))),
                                  int(args.get("stream", e.get("tid", 0))), start, end))
    cards = {int(p["id"]): p.get("name", "?") for p in trace.get("deviceProperties", [])
             if "id" in p}
    return sorted(events, key=lambda e: e.start), cards, window


def _merged(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint [start, end]."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def analyze(path) -> dict:
    """Device time of one trace by category, and the totals a busy share
    divides:

    * ``by_category_ms``: summed durations by :func:`classify`'s category,
      largest first (``events_by_category``: their numbers of events);
    * ``ops_busy_ms``: the sum over the categories;
    * ``busy_union_ms``: the union of each card's device intervals, summed
      over the cards.  A busy share divides this: the sum overcounts where
      a side stream's copy runs under a kernel;
    * ``span_ms``: from the first device event to the last (0 with none);
    * ``trace_span_ms``: from the first event of any kind to the last, the
      traced window (0 for an empty trace);
    * ``async_copy_ms``: copy time on streams other than the count
      kernel's on the same card;
    * ``launches``: the events of each kernel of the port, keyed by its
      launch counter (:data:`LAUNCH_NAMES`);
    * ``transfer_overlap``: :func:`covered_share` of the trace (None when it
      holds no peer copy and no NCCL kernel);
    * ``device_events``, ``cards`` (the cards with device events, by the
      trace's names for them).
    """
    events, names, window = read(path)
    by_cat: collections.Counter = collections.Counter()
    count: collections.Counter = collections.Counter()
    for e in events:
        by_cat[e.category] += e.end - e.start
        count[e.category] += 1
    per_card = _per_card(events)
    count_streams = {(e.card, e.stream) for e in events if e.category == COUNT_KERNEL}
    async_us = sum(e.end - e.start for e in events
                   if e.cat == "gpu_memcpy" and (e.card, e.stream) not in count_streams)
    return {
        "by_category_ms": {k: v / 1e3 for k, v in by_cat.most_common()},
        "events_by_category": {k: count[k] for k, _ in by_cat.most_common()},
        "ops_busy_ms": sum(by_cat.values()) / 1e3,
        "busy_union_ms": sum(e - s for per in per_card.values()
                             for s, e in _merged(iv for ivs in per.values() for iv in ivs)) / 1e3,
        "span_ms": (max(e.end for e in events) - events[0].start) / 1e3 if events else 0.0,
        "trace_span_ms": (window[1] - window[0]) / 1e3 if window else 0.0,
        "async_copy_ms": async_us / 1e3,
        "launches": {k: sum(1 for e in events if e.cat == "kernel" and name in e.name)
                     for k, name in LAUNCH_NAMES.items()},
        "transfer_overlap": covered_share(_transfers_and_kernels(per_card)),
        "device_events": len(events),
        "cards": {str(c): names.get(c, f"device {c}") for c in sorted(per_card)},
    }


def _per_card(events) -> dict:
    out: dict = {}
    for e in events:
        out.setdefault(e.card, collections.defaultdict(list))[e.category].append(
            (e.start, e.end))
    return {card: dict(per) for card, per in out.items()}


def _transfers_and_kernels(per_card: dict) -> list:
    return [(card, "transfer" if cat == PEER else "kernel", s, e)
            for card, per in per_card.items() for cat in (PEER, COUNT_KERNEL)
            for s, e in per.get(cat, ())]


def covered_share(intervals: list) -> dict | None:
    """The share of transfer time under count-kernel time on the same card.
    ``intervals`` holds (card, kind, start us, end us) with kind "transfer"
    or "kernel"; a transfer counts as covered only by its own card's
    kernels, and overlapping kernels count once.  None when there is no
    transfer: a ring of one position has no hop."""
    total = covered = events = 0.0
    for card in {c for c, *_ in intervals}:
        transfers = sorted((s, e) for c, k, s, e in intervals if c == card and k == "transfer")
        merged = _merged((s, e) for c, k, s, e in intervals if c == card and k == "kernel")
        events += len(transfers)
        for s, e in transfers:
            total += e - s
            covered += sum(max(0.0, min(e, ke) - max(s, ks)) for ks, ke in merged)
    if not events:
        return None
    return {"transfer_ms": total / 1e3, "covered_ms": covered / 1e3,
            "overlap_fraction": covered / total if total else 1.0,
            "num_transfers": int(events)}
