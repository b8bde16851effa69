"""The host's time in a sweep with no step queued on the device, in ms per
sweep: the ``engine.run`` spans less their step loops (``engine.steps``)
and their count reads (``engine.count_read``, which wait for the queued
steps), over the sweeps they ran (``sweeps``), summed over the window.
What is left is the ends of a sweep: the schedule built (twice), the hit
buffer made, the rows fetched and sorted.  It moves ``sweep_pairs_per_s``."""

from kingbench.spans import count, recorded, seconds


def read(ctx: dict) -> float | None:
    runs = recorded("engine.run")
    sweeps = count(runs, "sweeps")
    if not sweeps:
        return None
    inside = seconds(recorded("engine.steps")) + seconds(recorded("engine.count_read"))
    return (seconds(runs) - inside) / sweeps * 1e3
