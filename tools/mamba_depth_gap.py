#!/usr/bin/env python3
"""mamba2-1.3b at full width on the CPU: how far the last logits of a
prefill over T + 1 tokens lie from a prefill over the first T plus one
decode step (the chunked SSD scan against its recurrence), as a share of
the largest |logit|, at several depths, in the port and in the JAX
package.  Phase 16.2 of ``chip_smoke.py`` holds each layer of this
comparison in lockstep and prints the whole stack's gap; this script
shows how that gap grows with depth off the card.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/mamba_depth_gap.py \\
        [--T 512] [--depths 8 16 32 48] [--jax-depths 8 16]

The port's params come from its own init (``torch.Generator`` seed 0)
and its tokens from a generator seeded 1; the JAX package's from
``jax.random.key(0)`` and ``numpy.random.RandomState(1)``.  Batch 1.
Prints one JSON object: {"port": {depth: gap}, "jax": {depth: gap}}.
This script runs the JAX package and is not part of the port.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

ARCH = "mamba2-1.3b"


def port_gap(n_layers: int, T: int) -> float:
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import Model
    cfg = dataclasses.replace(get_arch(ARCH), n_layers=n_layers)
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.randint(0, cfg.vocab_size, (1, T + 1), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want, _ = model.prefill(params, {"tokens": toks})
        _, caches = model.prefill(params, {"tokens": toks[:, :-1]})
        got, _ = model.decode_step(params, toks[:, -1:], caches, T)
    return float((got - want).abs().max()) / float(want.abs().max())


def jax_gap(n_layers: int, T: int) -> float:
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_arch
    from repro.models import Model
    cfg = dataclasses.replace(get_arch(ARCH), n_layers=n_layers)
    model = Model(cfg)
    params = model.init(jax.random.key(0))
    toks = jnp.asarray(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (1, T + 1)).astype(np.int32))
    prefill = jax.jit(lambda p, t: model.prefill(p, {"tokens": t}))
    want, _ = prefill(params, toks)
    _, caches = prefill(params, toks[:, :-1])
    got, _ = jax.jit(model.decode_step)(params, toks[:, -1:], caches,
                                        jnp.asarray(T, jnp.int32))
    want, got = np.asarray(want), np.asarray(got)
    return float(np.abs(got - want).max() / np.abs(want).max())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--T", type=int, default=512)
    ap.add_argument("--depths", type=int, nargs="*", default=[8, 16, 32, 48])
    ap.add_argument("--jax-depths", type=int, nargs="*", default=[8, 16])
    args = ap.parse_args(argv)
    out = {"port": {d: port_gap(d, args.T) for d in args.depths},
           "jax": {d: jax_gap(d, args.T) for d in args.jax_depths}}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
