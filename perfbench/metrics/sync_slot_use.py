"""fed_mesh sync: the share (%) of the buffer slots voted over (K x cap a
sync) that held a stump, over the window's syncs."""


def read(ctx):
    K, cap = ctx["shape"]["K"], ctx["shape"]["cap"]
    syncs = [n_buf for synced, n_buf in ctx["steps"] if synced]
    if not syncs:
        return None
    return 100.0 * K * sum(syncs) / (K * cap * len(syncs))
