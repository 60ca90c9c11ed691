"""Whole round, where the card's busy time is the cell's rate: the share
(%) of the chip's peak that the traced federations' rounds reached in the
card's busy seconds: their least seconds (``cost.local_round`` a round and
``cost.sync`` a sync) over the seconds in which an operation ran on the
card."""
from perfbench import cost


def read(ctx):
    tr = ctx.get("traced")
    if not tr or not tr["busy_s"]:
        return None
    sh = ctx["shape"]
    K, n, nv, F, T = sh["K"], sh["n"], sh["nv"], sh["F"], sh["T"]
    rnd = cost.local_round(K, n, F, T, tr["misses"])
    least = sum(rnd + (cost.sync(K, n, nv, F, K * n_buf) if synced else 0.0)
                for synced, n_buf in tr["steps"])
    return 100.0 * least / tr["busy_s"]
