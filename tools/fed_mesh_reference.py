#!/usr/bin/env python3
"""The JAX package's mesh-integrated federated boost (``repro.core.
fed_mesh``) on the runs of ``chip_smoke.py`` phase 14, on the CPU: the
numbers its ``MESH_REFERENCE`` holds.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 tools/fed_mesh_reference.py \\
        [domain ...]

Each domain (default: the five paper domains and ``mobile_x4``) runs at
its registered size with K = its ``n_clients``, each client's shard cut to
the smallest client's rows and the validation set split evenly over the
clients (as ``tests/test_fed_mesh.py`` stacks them), ``FedBoostConfig
(n_clients=K)`` for its ``n_rounds`` (80) rounds, buffer cap 8 and
``ens_cap = K·n_rounds``, on a mesh of K placeholder CPU devices with
``AxisType.Auto`` axes (jax 0.9 makes Explicit axes by default, which the
step's gather refuses).  Each domain runs in a process of its own, since
the device count is fixed when JAX starts.  Prints one JSON object:
domain -> ens_count, syncs, interval_first, interval_last, val_err and
``first_nonfinite_D`` (the first round after which some client's
distribution holds a NaN or an infinity, or null).  This script runs the
JAX package and is not part of the port.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

RUNS = ("edge_vision", "blockchain", "mobile", "iot", "healthcare",
        "mobile_x4")
CAP = 8

ONE = """
import json, os, sys
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs.paper_fedboost import FedBoostConfig
from repro.core import fed_mesh
from repro.data import make_domain_data
from repro.models.weak import stump_thresholds
from repro.sim.scenarios import SCENARIOS
name, cap = sys.argv[1], int(sys.argv[2])
dom = SCENARIOS[name].domain
K = dom.n_clients
data = make_domain_data(dom, seed=0)
n_local = min(c[0].shape[0] for c in data["clients"])
x = jnp.stack([c[0][:n_local] for c in data["clients"]])
y = jnp.stack([c[1][:n_local] for c in data["clients"]])
xv, yv = data["val"]
nvl = xv.shape[0] // K
xv, yv = xv[:K * nvl].reshape(K, nvl, -1), yv[:K * nvl].reshape(K, nvl)
mesh = jax.make_mesh((K,), ("clients",),
                     axis_types=(jax.sharding.AxisType.Auto,))
cfg = FedBoostConfig(n_clients=K)
step = jax.jit(fed_mesh.make_fed_boost_step(
    cfg, mesh, "clients", stump_thresholds(x.reshape(-1, x.shape[-1]))))
state = fed_mesh.init_state(cfg, K, n_local, nvl, buffer_cap=cap,
                            ens_cap=K * cfg.n_rounds, key=jax.random.key(0))
sh = jax.tree.map(lambda s: NamedSharding(mesh, s),
                  fed_mesh.state_shardings(mesh, "clients"),
                  is_leaf=lambda v: isinstance(v, P))
state = jax.device_put(state, sh)
dsh = NamedSharding(mesh, P("clients"))
x, y, xv, yv = (jax.device_put(a, dsh) for a in (x, y, xv, yv))
intervals, bad = [], None
for r in range(cfg.n_rounds):
    state = step(state, x, y, xv, yv)
    intervals.append(float(state.interval))
    if bad is None and not bool(jnp.isfinite(state.D).all()):
        bad = r
print(json.dumps({"ens_count": int(state.ens_count),
                  "syncs": int(state.sync_count),
                  "interval_first": intervals[0],
                  "interval_last": intervals[-1],
                  "val_err": float(state.prev_err),
                  "first_nonfinite_D": bad}))
"""


def n_clients(name: str) -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.sim.scenarios import SCENARIOS
    return SCENARIOS[name].domain.n_clients


def main(argv=None) -> None:
    out = {}
    for name in (argv or sys.argv[1:]) or RUNS:
        env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_"
                   f"device_count={n_clients(name)}", JAX_PLATFORMS="cpu")
        run = subprocess.run([sys.executable, "-c", ONE, name, str(CAP)],
                             env=env, capture_output=True, text=True,
                             check=True)
        out[name] = json.loads(run.stdout.strip().splitlines()[-1])
    print(json.dumps(out))


if __name__ == "__main__":
    main()
