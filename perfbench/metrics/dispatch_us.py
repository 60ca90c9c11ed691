"""Dispatcher, wrappers: the median host us of a ``kernel.<name>`` span in
the traced federations, from the dispatcher's entry (bucket, plan, layout
split) to the launch's return."""
import statistics

from perfbench.spans import host_ms, traced_spans


def read(ctx):
    us = [host_ms(s) * 1e3 for s in traced_spans()
          if s["name"].startswith("kernel.")]
    return statistics.median(us) if us else None
