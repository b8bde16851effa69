"""Where the device's time went, read from a ``torch.profiler`` Chrome trace.

The twin of ``tools/trace_report.py``'s reader (``CATEGORIES``,
``classify``, ``analyze``, ``_intervals_per_plane``, ``ppermute_overlap``,
``report``), which reads a ``jax.profiler`` xplane.  The input here is the
JSON file that ``torch.profiler``'s ``export_chrome_trace`` writes: a trace
of the CLI's ``--profile_dir`` (``trace-part-NNNNN.json``), of
``tools/torch_trace_report.py``, or of :func:`traced`, which also reads
the trace it writes.

Device activity is the complete (``"ph": "X"``) events of three
categories, ``kernel``, ``gpu_memcpy`` and ``gpu_memset``; each names its
card (``args.device``) and stream (``args.stream``).  The JAX reader skips
control-flow containers, whose events span the kernels inside them.  CUDA
device activities do not nest, so nothing here is skipped; the annotations
that the profiler draws on the device's timeline (``gpu_user_annotation``)
span other events and are not device activity.  A trace of a CPU run has
no device events, and reads as zero device time.

Times in a trace are microseconds; every ``*_ms`` value here is in
milliseconds.  Reading needs only ``json``; :func:`traced` imports
``torch.profiler`` when it is called.  :func:`append_events` adds events
to a trace file as it copies it (the CLI's ``--profile_dir`` adds the
port's spans so).
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import re
import tempfile
from typing import NamedTuple

COUNT_KERNEL = "count kernel"
EMIT_KERNEL = "emit kernel"
PEER = "peer copy / NCCL"
MEMSET = "memset"
OTHER_KERNELS = "other kernels"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

# The kernels' names in a trace, by the names of their launch counters
# (``king_cuda.launches``, ``king_emit.emit_launches``).  :func:`classify`
# files any kernel whose name holds ``king_counts`` as a count kernel.
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


def read(path: str) -> tuple[list[DeviceEvent], dict, tuple[float, float] | None]:
    """(the device events of the trace at ``path`` in time order, the card
    names its ``deviceProperties`` give by card, the (first start, last end)
    in us of all its events, host ones included, or None for an empty
    trace)."""
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


# How much of a trace's head and of its tail append_events reads.
_EDGE_BYTES = 1 << 16


def append_events(path: str, dst, events_at) -> None:
    """Copies the Chrome trace at ``path`` to the binary stream ``dst`` with
    the events ``events_at(base_ns)`` added at the end of its
    ``traceEvents``, ``base_ns`` being the trace's ``baseTimeNanoseconds``.
    The trace is copied as a stream and never parsed whole: only its head
    and its tail are read apart.  A trace without ``baseTimeNanoseconds``,
    or whose ``traceEvents`` does not end in its tail, raises ValueError."""
    size = os.path.getsize(path)
    with open(path, "rb") as src:
        head = src.read(_EDGE_BYTES)
        tail_at = max(0, size - _EDGE_BYTES)
        src.seek(tail_at)
        tail = src.read()
        base = (re.search(rb'"baseTimeNanoseconds"\s*:\s*(\d+)', head)
                or re.search(rb'"baseTimeNanoseconds"\s*:\s*(\d+)', tail))
        if base is None:
            raise ValueError(f"{path}: the trace has no baseTimeNanoseconds")
        close = _events_end(tail)
        if close is None:
            raise ValueError(f"{path}: no end of traceEvents in the trace's tail")
        src.seek(0)
        left = tail_at + close
        while left:
            chunk = src.read(min(left, _EDGE_BYTES))
            dst.write(chunk)
            left -= len(chunk)
    events = events_at(int(base.group(1)))
    if events:
        sep = b"" if tail[:close].rstrip().endswith(b"[") else b","
        dst.write(sep + b",\n".join(json.dumps(e).encode() for e in events) + b"\n")
    dst.write(tail[close:])


def _events_end(tail: bytes) -> int | None:
    """The offset in ``tail`` of the ``]`` that closes ``traceEvents``: the
    last one after which the trace's object ends, or goes on with keys."""
    at = len(tail)
    while (at := tail.rfind(b"]", 0, at)) >= 0:
        rest = tail[at + 1:].strip()
        if rest == b"}":
            return at
        if rest[:1] == b",":
            try:
                if isinstance(json.loads(b"{" + rest[1:]), dict):
                    return at
            except ValueError:
                pass
    return None


def _merged(intervals) -> list:
    """The union of (start, end) intervals, as sorted disjoint [start, end]."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def analyze(path: str) -> dict:
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


def intervals_per_card(path: str) -> dict:
    """{card: {category: [(start us, end us), ...]}} of a trace's device
    events, in time order.  Overlap questions (does this card's transfer
    run under this card's kernels?) are answered per card: pooling cards
    would let one card's kernel cover another card's copy."""
    return _per_card(read(path)[0])


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


def report(tag: str, stats: dict, card: str | None = None) -> str:
    """:func:`analyze`'s reading as a table, headed by ``tag`` and the card
    (``card``, e.g. nvidia-smi's name and power limit; else the trace's
    names for its cards)."""
    who = card or ", ".join(stats["cards"].values()) or "no card in the trace"
    lines = [f"== {tag} ({who}) =="]
    if not stats["device_events"]:
        lines.append("  no device events in the trace (a CPU run): device time not measured")
        return "\n".join(lines)
    span, cards = stats["span_ms"], len(stats["cards"])
    lines.append(f"  device busy {stats['busy_union_ms']:.3f} ms (union per card) of a "
                 f"{span:.3f} ms device span, {100 * stats['busy_union_ms'] / max(span * cards, 1e-9):.2f}%"
                 f" busy; traced window {stats['trace_span_ms']:.3f} ms")
    lines.append(f"  ops summed {stats['ops_busy_ms']:.3f} ms; copies off the count kernel's "
                 f"stream {stats['async_copy_ms']:.3f} ms; launches {stats['launches']}")
    overlap = stats["transfer_overlap"]
    lines.append("  peer copies / NCCL: none in the trace, so no share under count-kernel "
                 "time (one position makes no hop)" if overlap is None else
                 f"  transfer under count-kernel time on its card: {overlap}")
    for k, ms in stats["by_category_ms"].items():
        n = stats["events_by_category"][k]
        lines.append(f"    {k:20s} {n:7d} x {ms / n:9.4f} ms = {ms:10.3f} ms "
                     f"{100 * ms / stats['ops_busy_ms']:6.2f}%")
    return "\n".join(lines)


@contextlib.contextmanager
def traced(path: str | None = None, cuda: bool = True):
    """Profiles the body under ``torch.profiler`` (CPU activity, and with
    ``cuda`` the CUDA activity), writes its Chrome trace to ``path`` (with
    None, to a temporary file that is then deleted), and fills the dict it
    yields with :func:`analyze`'s reading of that trace when the body
    ends."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    stats: dict = {}
    with profile(activities=activities) as prof:
        yield stats
    with tempfile.TemporaryDirectory() as tmp:
        out = path or os.path.join(tmp, "trace.json")
        os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
        prof.export_chrome_trace(out)
        stats.update(analyze(out))
