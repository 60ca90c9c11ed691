"""fed_mesh sync: the median host ms of a ``fed_mesh.sync.read_back`` span
in the traced federations: how long the sync's one read back waits for the
card, the card's backlog at a sync (about 0 where the host sets the
pace)."""
import statistics

from perfbench.spans import host_ms, traced_spans


def read(ctx):
    ms = [host_ms(s) for s in traced_spans()
          if s["name"] == "fed_mesh.sync.read_back"]
    return statistics.median(ms) if ms else None
