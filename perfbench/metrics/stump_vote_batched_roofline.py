"""CUDA kernels: the share (%) of its roofline that ``stump_vote_batched``
reached in the traced federations: the calls' least seconds (``cost.py``,
two calls a sync: over the clients' rows and over their validation rows,
every slot of the K x cap buffers voted) over the kernel's device seconds
in the profiler's trace, the traced time scaled to every call where the
trace dropped a kernel event.

Its bytes are those of a sync that materialises the (K, K x cap, rows)
buffer of every slot's feature column and votes each slot, so
``BENCHMARK.json`` lists the cells whose sync does that.  A cell whose sync
reads x through the feature index brings a roofline reader of its own,
with that vote's operations and bytes counted in the benchmark."""
from perfbench import cost

KERNEL = "stump_vote_kernel"


def read(ctx):
    tr = ctx.get("traced")
    if not tr:
        return None
    dev = sum(s for name, (s, _) in tr["device_ops"].items() if KERNEL in name)
    events = sum(e for name, (_, e) in tr["device_ops"].items()
                 if KERNEL in name)
    syncs = sum(1 for synced, _ in tr["steps"] if synced)
    if not dev or not events or not syncs:
        return None
    sh = ctx["shape"]
    M = sh["K"] * sh["cap"]
    least = syncs * sum(cost.least_s(*cost.stump_vote_batched(sh["K"], M, r))
                        for r in (sh["n"], sh["nv"]))
    return 100.0 * least / (dev * 2 * syncs / events)
