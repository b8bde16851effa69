"""The device's idle share (%) of a sweep cell's traced window, the gaps
between sweeps included.  It moves ``sweep_pairs_per_s``."""

from kingbench.tracing import idle_share


def read(ctx: dict) -> float | None:
    return idle_share(ctx)
