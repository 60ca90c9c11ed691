"""fed_mesh sync: the median over the traced federations' syncs of the
device ms of a sync's two ``fed_mesh.sync.gather`` spans (the (K, M, n)
and (K, M, nv) row gathers, CUDA events on the card), summed.  Nothing on
the CPU."""
import statistics

from perfbench.spans import children, traced_spans


def read(ctx):
    gathers = children(traced_spans(), "fed_mesh.sync.gather")
    ms = [sum(g["attrs"]["device_ms"] for g in gs)
          for gs in gathers.values()
          if all("device_ms" in g["attrs"] for g in gs)]
    return statistics.median(ms) if ms else None
