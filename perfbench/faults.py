"""Faults planted in the program for ``calibrate.py`` and the tests: each
breaks the timed path underneath the harness, which must then find the run
not correct.

* ``unchanged``: the step returns its state unchanged;
* ``half_batch``: every client's fit sees half of its rows, the weights
  renormalised over the rest;
* ``no_exchange``: the sync's foreign update is left out (the first vote
  of each sync, the stumps crossing the client axis, returns zeros);
* ``altered_answer``: client 0's stump has its polarity flipped where the
  fit produces it.
"""
from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half_batch", "no_exchange", "altered_answer")


@contextlib.contextmanager
def planted(name: str):
    """Patch the program for fault ``name``; yields the step wrapper to
    hand ``harness.run`` (or None)."""
    import torch
    from repro_torch.core import fed_mesh
    from repro_torch.kernels import ops
    fit, vote = fed_mesh.fit_clients, ops.stump_vote_batched
    wrap = None
    if name == "unchanged":
        wrap = lambda step: (lambda s, *inputs: s)
    elif name == "half_batch":
        def half(x, y, D, thr, policy=None):
            D = D.clone()
            D[:, max(1, D.shape[1] // 2):] = 0.0
            return fit(x, y, D / D.sum(1, keepdim=True), thr, policy)
        fed_mesh.fit_clients = half
    elif name == "no_exchange":
        calls = [0]

        def local_only(xsel, thr, pol, alphas, **kw):
            calls[0] += 1
            out = vote(xsel, thr, pol, alphas, **kw)
            return torch.zeros_like(out) if calls[0] % 2 else out
        ops.stump_vote_batched = local_only
    elif name == "altered_answer":
        def altered(x, y, D, thr, policy=None):
            params, eps = fit(x, y, D, thr, policy)
            params = params.clone()
            params[0, 2] = -params[0, 2]
            return params, eps
        fed_mesh.fit_clients = altered
    else:
        raise KeyError(f"unknown fault {name!r}; one of {FAULTS}")
    try:
        yield wrap
    finally:
        fed_mesh.fit_clients, ops.stump_vote_batched = fit, vote
