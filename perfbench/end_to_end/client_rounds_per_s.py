"""Client-rounds a second: K times the boosting rounds completed in the
window, a round of a federation that the window's end cut counting, over the
window's seconds (host clock, closed by a synchronize)."""


def read(ctx):
    return ctx["shape"]["K"] * ctx["rounds"] / ctx["window_s"]
