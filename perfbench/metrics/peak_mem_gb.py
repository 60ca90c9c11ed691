"""Device: the allocator's peak over the set-up's end and the window, GB."""


def read(ctx):
    return ctx["peak_bytes"] / 1e9 if ctx["peak_bytes"] else None
