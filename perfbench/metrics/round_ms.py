"""fed_mesh local round: the median device ms of a window's step that did
not sync (CUDA events around the step call)."""
import statistics


def read(ctx):
    ms = ctx.get("round_ms")
    return statistics.median(ms) if ms else None
