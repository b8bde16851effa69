"""Port of ``cuking_tpu/utils/stopwatch.py``, and the port's span recorder.

Stage timing, the analogue of the reference's StopWatch (cuking.cu:326-337).

The reference prints per-stage wall-clock durations to stdout after every
pipeline stage (call sites at cuking.cu:467-877) and a progress dot every 1024
Parquet files (cuking.cu:705-708).  This module provides the same, and
records named spans of the port's work while a ``torch.profiler`` records.

Spans.  :func:`span` opens one; closing it (the ``with`` block's end, or
``close()``) stamps its end.  A span holds its name, start and end on the
clock of ``torch.profiler``'s Chrome trace (Unix-epoch ns, so
``(start_ns - trace["baseTimeNanoseconds"]) / 1e3`` is its ``ts``), the
native id of its thread, its own id, its parent's (the span open around
it on its thread, or the one handed to a worker thread) and its root's,
and counts taken at its boundary (bytes, entries, steps, rows).  The root
names one request: ``cli.task`` for a CLI invocation, ``engine.run`` for
a direct ``KingEngine.run()``.  Stamps are ``time.perf_counter_ns`` shifted
by one reading of both clocks at import, so a step of the system clock
cannot bend a span.

Tracing is on while a ``torch.profiler`` records: the check is
``torch.autograd._profiler_enabled()``, made on the thread that opens a
span with no parent given.  It reads false on every other thread, so a
worker's span takes its parent from the thread that opened it
(:func:`current`), and with it the decision.  When tracing is on, a span
on the profiler's thread also enters ``torch.profiler.record_function``
under its name: it lands in the trace as a ``user_annotation``, with a
``gpu_user_annotation`` twin on the device's timeline.  When it is off, a
span costs one flag check: no clock read, no annotation, no record.

:func:`recorded` returns the closed spans kept in this process (since
:func:`clear`); nothing is written anywhere but by the CLI's
``--profile_dir`` (:func:`chrome_events`).
"""

from __future__ import annotations

import itertools
import sys
import threading
import time
from dataclasses import dataclass, field

import torch

# Unix-epoch ns less perf_counter ns, read once.
_CLOCK_OFFSET_NS = time.time_ns() - time.perf_counter_ns()
# The category of the complete events chrome_events writes.
CHROME_CAT = "cuking_span"


def now_ns() -> int:
    """The spans' clock: Unix-epoch ns, stepped by ``perf_counter_ns``."""
    return time.perf_counter_ns() + _CLOCK_OFFSET_NS


@dataclass
class Span:
    """One span: times in ns on :func:`now_ns`'s clock, ``end_ns`` None
    while it is open."""

    name: str
    id: int
    parent: int | None
    root: int
    tid: int
    start_ns: int = 0
    end_ns: int | None = None
    counts: dict = field(default_factory=dict)


_spans: list[Span] = []
_ids = itertools.count(1)
_local = threading.local()


def _stack() -> list:
    """The spans open on this thread, innermost last."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
        # Read once a thread: it is a system call, and at a traced sweep's
        # ends its cost shows as device idle time.
        _local.tid = threading.get_native_id()
    return stack


class _Off:
    """The span of a run that is not traced: records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        pass

    def count(self, **counts) -> None:
        pass

    def close(self) -> None:
        pass


OFF = _Off()


class _On:
    """An open span that records."""

    __slots__ = ("span", "_stack", "_annotation")

    def __init__(self, name: str, parent: _On | None, counts: dict, annotate: bool):
        sid = next(_ids)
        up = parent.span if parent is not None else None
        self._stack = _stack()
        self.span = Span(name, sid, up.id if up else None, up.root if up else sid,
                         _local.tid, counts=counts)
        self._stack.append(self)
        _spans.append(self.span)
        self._annotation = None
        # Stamped before the annotation's call, which lets the GIL go: a wait
        # to take it back then falls after both edges, not between them.
        self.span.start_ns = now_ns()
        if annotate:
            self._annotation = torch.profiler.record_function(name)
            self._annotation.__enter__()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def count(self, **counts) -> None:
        self.span.counts.update(counts)

    def close(self) -> None:
        """Stamps the end; first closes, innermost first, what is still
        open inside it on its thread (a stage that raised before its
        end).  Closing twice is a no-op."""
        if self.span.end_ns is not None:
            return
        stack = self._stack
        if self in stack:
            while stack[-1] is not self:
                stack[-1].close()
            stack.pop()
        self.span.end_ns = now_ns()
        if self._annotation is not None:
            self._annotation.__exit__(None, None, None)


def span(name: str, parent: _On | _Off | None = None, **counts):
    """Opens the span ``name`` with ``counts`` and returns it: a context
    manager that closes it, with ``count(**counts)`` to add counts and
    ``close()``.  With no ``parent`` it records only while a profiler
    records on this thread, inside the span open here; a worker thread
    passes the span it was handed (:func:`current`), and records when
    that one does."""
    if parent is None:
        if not torch.autograd._profiler_enabled():
            return OFF
        stack = _stack()
        return _On(name, stack[-1] if stack else None, counts, True)
    if parent is OFF:
        return OFF
    return _On(name, parent, counts, torch.autograd._profiler_enabled())


def current() -> _On | _Off:
    """The innermost span open on this thread (OFF when none is): what a
    worker thread's spans take as ``parent``."""
    stack = _stack()
    return stack[-1] if stack else OFF


def recorded() -> list[Span]:
    """The closed spans of this process since the last :func:`clear`, in
    the order they opened."""
    return [s for s in _spans if s.end_ns is not None]


def clear() -> None:
    _spans.clear()


def chrome_events(spans: list[Span], base_ns: int, pid: int) -> list[dict]:
    """``spans`` as complete events of a Chrome trace whose
    ``baseTimeNanoseconds`` is ``base_ns``: ``"cat": "cuking_span"``,
    ``ts`` and ``dur`` in us on the trace's clock, the span's thread as
    ``tid``, its ids and counts as ``args``."""
    return [{"ph": "X", "cat": CHROME_CAT, "name": s.name, "pid": pid, "tid": s.tid,
             "ts": (s.start_ns - base_ns) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {"id": s.id, "parent": s.parent, "root": s.root, **s.counts}}
            for s in spans]


@dataclass
class StopWatch:
    """Tracks elapsed time between calls."""

    _last: float = field(default_factory=time.monotonic)

    def get_elapsed_and_reset(self) -> float:
        now = time.monotonic()
        elapsed = now - self._last
        self._last = now
        return elapsed


class StageLogger:
    """Prints ``<message>... (<elapsed>)`` around pipeline stages, each a
    span ``stage.<stage>``.

    Mirrors the reference's ``std::cout << "Reading metadata...";`` /
    ``" (" << stop_watch.GetElapsedAndReset() << ")"`` pattern
    (cuking.cu:468-502).  ``enabled`` governs the printing only: the spans
    are recorded either way.
    """

    def __init__(self, stream=None, enabled: bool = True):
        self._stream = stream if stream is not None else sys.stdout
        self._enabled = enabled
        self._watch = StopWatch()
        self._span = OFF

    def begin(self, message: str, stage: str) -> None:
        self._span = span(f"stage.{stage}")
        self._watch.get_elapsed_and_reset()
        if self._enabled:
            self._stream.write(message)
            self._stream.flush()

    def end(self) -> float:
        elapsed = self._watch.get_elapsed_and_reset()
        self._span.close()
        self._span = OFF
        if self._enabled:
            self._stream.write(f" ({elapsed:.3f}s)\n")
            self._stream.flush()
        return elapsed

    def print(self, message: str) -> None:
        if self._enabled:
            self._stream.write(message + "\n")
            self._stream.flush()

    def dot(self) -> None:
        """Progress indicator, mirroring cuking.cu:705-708."""
        if self._enabled:
            self._stream.write(".")
            self._stream.flush()
