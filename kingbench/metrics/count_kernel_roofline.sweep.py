"""The count kernel's share (%) of its roofline in a sweep cell: the least
time the card could take for the window's sweeps (``roofline.py``: the
shard's work, not the kernel's launches) over the count kernel's device
time in the trace.  It moves ``sweep_pairs_per_s``."""

from kingbench.frozen.trace import COUNT_KERNEL
from kingbench.roofline import count_bound_s


def read(ctx: dict) -> float | None:
    ms = ctx["trace"]["by_category_ms"].get(COUNT_KERNEL)
    if not ms or not ctx["units"]:
        return None
    w = ctx["work"]
    bound = ctx["units"] * count_bound_s(w["unique_pairs"], w["samples"], w["sites"])
    return 100 * bound / (ms / 1e3)
