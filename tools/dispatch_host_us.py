#!/usr/bin/env python3
"""The host time the kernel dispatcher adds to one ``ops`` call, with the
backend's own work taken out, on any machine (no card needed).

    PYTHONPATH=src python3 tools/dispatch_host_us.py

At the replay path's commonest stump vote launch, (B, T, N) = (1, 477, 1)
on the CPU, the plain version of ``stump_vote_batched`` is replaced by a
function that returns at once, and two variants are timed in turns (the
order rotates and reverses from round to round, 15 rounds of 20,000
calls):

- ``wrapper``: ``ops.stump_vote_batched`` through the dispatcher;
- ``no_op``: the stand-in called directly.

The difference of the medians is the dispatcher's host work a call: the
bucket, the device check over the call's tensors, the plan cache keyed on
the environment variable, the two records the policy keeps
(``choices``, ``layout_choices``) and the calls between them.  Prints one
JSON object: the median, least and most µs a call of each variant and
the difference, with the host's CPU count.  (``chip_smoke.py`` phase 13.4
measures the same difference on the card's host against the cuda
backend's launch code.)
"""
from __future__ import annotations

import json
import os
import statistics
import time

import torch

from repro_torch.kernels import dispatch, ops


def main() -> dict:
    gen = torch.Generator().manual_seed(0)
    args = (torch.randn((1, 477, 1), generator=gen),
            torch.randn((1, 477), generator=gen), torch.ones((1, 477)),
            torch.rand((1, 477), generator=gen))

    def no_op(*a, **kw):
        return None
    plain = dispatch._TORCH_IMPLS["stump_vote_batched"]
    dispatch._TORCH_IMPLS["stump_vote_batched"] = no_op
    variants = {"wrapper": lambda: ops.stump_vote_batched(*args),
                "no_op": lambda: no_op(*args)}
    times = {k: [] for k in variants}
    try:
        names = list(variants)
        for r in range(15):
            order = names[r % 2:] + names[:r % 2]
            for k in (order if r % 2 == 0 else order[::-1]):
                fn = variants[k]
                fn()
                t0 = time.perf_counter()
                for _ in range(20000):
                    fn()
                times[k].append((time.perf_counter() - t0) / 20000 * 1e6)
    finally:
        dispatch._TORCH_IMPLS["stump_vote_batched"] = plain
    out = {k: dict(median=statistics.median(v), min=min(v), max=max(v))
           for k, v in times.items()}
    out["dispatcher_us"] = out["wrapper"]["median"] - out["no_op"]["median"]
    out["cpus"] = os.cpu_count()
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
