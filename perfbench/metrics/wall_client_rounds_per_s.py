"""Whole round: client-rounds a second by the host's clock, K times the
rounds completed in the window over its seconds, as ``client_rounds_per_s``
reads it; a per-layer metric where the host sets the pace and the rate
spreads with the host's speed."""


def read(ctx):
    return ctx["shape"]["K"] * ctx["rounds"] / ctx["window_s"]
