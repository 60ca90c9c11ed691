"""fed_mesh local round: the median host ms of a ``fed_mesh.round`` span in
the traced federations, the host's enqueue of a round; beside ``round_ms``
it says which side sets the pace."""
import statistics

from perfbench.spans import host_ms, traced_spans


def read(ctx):
    ms = [host_ms(s) for s in traced_spans() if s["name"] == "fed_mesh.round"]
    return statistics.median(ms) if ms else None
