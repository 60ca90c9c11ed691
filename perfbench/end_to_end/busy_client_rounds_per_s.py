"""Client-rounds a second of the card's busy time: K times the boosting
rounds of the traced federations (four whole ones after the window, under
the profiler) over the seconds in which an operation ran on the card in
them (the union of the device operations' intervals).  The card's work a
round, whichever side sets the pace; nothing where the trace holds no
device operation."""


def read(ctx):
    tr = ctx.get("traced")
    if not tr or not tr["busy_s"]:
        return None
    return ctx["shape"]["K"] * len(tr["steps"]) / tr["busy_s"]
