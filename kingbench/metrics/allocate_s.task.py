"""The CLI's "Allocating bit planes..." stage, in s, the mean over the
window's tasks.  It moves ``task_s``."""


def read(ctx: dict) -> float | None:
    stages = ctx["stages"]
    return sum(s["allocate"] for s in stages) / len(stages) if stages else None
