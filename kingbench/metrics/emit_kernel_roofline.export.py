"""The emit kernel's share (%) of its bytes bound in an export cell: the
window's tasks × the least time to emit every pair of the shard
(``emit_roofline.py``: the shard's pairs, not the kernel's launches) over
the emit kernel's device time in the trace.  It moves ``task_s``."""

from kingbench.emit_roofline import emit_bound_s
from kingbench.frozen.trace import EMIT_KERNEL


def read(ctx: dict) -> float | None:
    ms = ctx["trace"]["by_category_ms"].get(EMIT_KERNEL)
    if not ms or not ctx["units"]:
        return None
    return 100 * ctx["units"] * emit_bound_s(ctx["work"]["unique_pairs"]) / (ms / 1e3)
