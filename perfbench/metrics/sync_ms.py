"""fed_mesh sync: the median device ms of a window's step that synced
(CUDA events around the step call)."""
import statistics


def read(ctx):
    ms = ctx.get("sync_ms")
    return statistics.median(ms) if ms else None
