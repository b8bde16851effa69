"""The host's time to queue one step of a sweep, in us: the step loops
(``engine.steps`` spans, first launch to last) less their waits for the
count copies (``engine.limit_wait``), over the steps they ran, summed
over the window's sweeps.  Once the device runs a step faster than the
host queues one, this sets the pace.  It moves ``sweep_pairs_per_s``.

It is read under the profiler, whose recording of every operator the
loop runs adds to each step: an upper bound on the untraced queue time,
not the profiler's cost alone (PERF.md §6 measures both)."""

from kingbench.spans import count, recorded, seconds


def read(ctx: dict) -> float | None:
    loops = recorded("engine.steps")
    steps = count(loops, "steps")
    if not steps:
        return None
    return (seconds(loops) - seconds(recorded("engine.limit_wait"))) / steps * 1e6
