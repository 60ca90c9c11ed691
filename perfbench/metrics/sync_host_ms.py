"""fed_mesh sync: the median host ms of a ``fed_mesh.sync`` span less its
``fed_mesh.sync.read_back`` child in the traced federations: the host's own
work in a sync, without its wait for the card."""
import statistics

from perfbench.spans import children, host_ms, traced_spans


def read(ctx):
    spans = traced_spans()
    waits = children(spans, "fed_mesh.sync.read_back")
    ms = [host_ms(s) - sum(host_ms(w) for w in waits.get(s["span"], ()))
          for s in spans if s["name"] == "fed_mesh.sync"]
    return statistics.median(ms) if ms else None
