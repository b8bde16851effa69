"""Port of ``cuking_tpu/utils/stopwatch.py`` (a copy).

Stage timing, the analogue of the reference's StopWatch (cuking.cu:326-337).

The reference prints per-stage wall-clock durations to stdout after every
pipeline stage (call sites at cuking.cu:467-877) and a progress dot every 1024
Parquet files (cuking.cu:705-708).  This module provides the same, plus an
optional structured record of all stages for observability.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field


@dataclass
class StopWatch:
    """Tracks elapsed time between calls; optionally records named stages."""

    _last: float = field(default_factory=time.monotonic)
    stages: list[tuple[str, float]] = field(default_factory=list)

    def get_elapsed_and_reset(self, stage: str | None = None) -> float:
        now = time.monotonic()
        elapsed = now - self._last
        self._last = now
        if stage is not None:
            self.stages.append((stage, elapsed))
        return elapsed


class StageLogger:
    """Prints ``<message>... (<elapsed>)`` around pipeline stages.

    Mirrors the reference's ``std::cout << "Reading metadata...";`` /
    ``" (" << stop_watch.GetElapsedAndReset() << ")"`` pattern
    (cuking.cu:468-502).
    """

    def __init__(self, stream=None, enabled: bool = True):
        self._stream = stream if stream is not None else sys.stdout
        self._enabled = enabled
        self._watch = StopWatch()

    def begin(self, message: str) -> None:
        self._watch.get_elapsed_and_reset()
        if self._enabled:
            self._stream.write(message)
            self._stream.flush()

    def end(self, stage: str | None = None) -> float:
        elapsed = self._watch.get_elapsed_and_reset(stage)
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

    @property
    def stages(self) -> list[tuple[str, float]]:
        return self._watch.stages
