"""CUDA kernels: the share (%) of its roofline that ``stump_scan_batched``
reached in the traced federations: the calls' least seconds (``cost.py``,
one call a round at the cell's shapes) over the kernel's device seconds in
the profiler's trace, the traced time scaled to every call where the trace
dropped a kernel event."""
from perfbench import cost

KERNEL = "stump_scan_batched_kernel"


def read(ctx):
    tr = ctx.get("traced")
    if not tr:
        return None
    dev = sum(s for name, (s, _) in tr["device_ops"].items() if KERNEL in name)
    events = sum(e for name, (_, e) in tr["device_ops"].items()
                 if KERNEL in name)
    calls = len(tr["steps"])
    if not dev or not events:
        return None
    sh = ctx["shape"]
    least = calls * cost.least_s(*cost.stump_scan_batched(
        sh["K"], sh["n"], sh["F"], sh["T"], tr["misses"]))
    return 100.0 * least / (dev * calls / events)
