"""The emit kernel's device time per launch (one a step), in us, from the
trace of a sweep cell's window.  It moves ``sweep_pairs_per_s``."""

from kingbench.frozen.trace import EMIT_KERNEL


def read(ctx: dict) -> float | None:
    t = ctx["trace"]
    n = t["events_by_category"].get(EMIT_KERNEL)
    return 1e3 * t["by_category_ms"][EMIT_KERNEL] / n if n else None
