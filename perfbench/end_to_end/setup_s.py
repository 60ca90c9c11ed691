"""Set-up seconds: from the process's start to the first timed round
(imports, the kernels' build or load, data, state, and the warm-up local
round and sync at the cell's shapes)."""


def read(ctx):
    return ctx["setup_s"]
