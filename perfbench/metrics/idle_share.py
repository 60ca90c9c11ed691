"""Device: the share (%) of the traced federations' wall time in which no
operation ran on the card (the profiler's timeline)."""


def read(ctx):
    tr = ctx.get("traced")
    if not tr or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["seconds"])
