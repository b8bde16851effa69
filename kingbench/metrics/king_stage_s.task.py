"""The CLI's "Running KING kernel for..." stage, in s, the mean over the
window's tasks: the engine's sweep and the count read, after the plane
upload where the planes are on the host (the rows' fetch and sort follow
the stage).  It moves ``task_s``."""


def read(ctx: dict) -> float | None:
    stages = ctx["stages"]
    return sum(s["king_kernel"] for s in stages) / len(stages) if stages else None
