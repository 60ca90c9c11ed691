"""Whole round: the share (%) of the chip's peak that the window's rounds
reached: their least seconds (the algorithm's operations and bytes from the
shapes, ``cost.local_round`` a round and ``cost.sync`` a sync) over the
window's seconds."""
from perfbench import cost


def read(ctx):
    if not ctx["rounds"] or "traced" not in ctx:
        return None
    sh = ctx["shape"]
    K, n, nv, F, T = sh["K"], sh["n"], sh["nv"], sh["F"], sh["T"]
    rnd = cost.local_round(K, n, F, T, ctx["traced"]["misses"])
    least = sum(rnd + (cost.sync(K, n, nv, F, K * n_buf) if synced else 0.0)
                for synced, n_buf in ctx["steps"])
    return 100.0 * least / ctx["window_s"]
