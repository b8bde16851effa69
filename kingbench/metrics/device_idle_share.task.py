"""The device's idle share (%) of a task cell's traced window: the whole
tasks, of which the device works in the engine's stage.  It moves
``task_s``."""

from kingbench.tracing import idle_share


def read(ctx: dict) -> float | None:
    return idle_share(ctx)
