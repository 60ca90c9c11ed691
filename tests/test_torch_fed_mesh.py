"""The port's mesh-integrated federated boost (``core/fed_mesh.py``) against
a live run of the JAX package's, on the CPU.

The reference runs in a subprocess with 8 placeholder CPU devices, as
``tests/test_fed_mesh.py`` runs it, but on a mesh of ``AxisType.Auto``
(jax 0.9 makes Explicit axes by default, which its gather of thresholds
over client-sharded indices refuses): edge_vision at K = 8, 40 rounds,
buffer cap 8, every round's state recorded as numpy.

* Lockstep: round r of the port starts from the reference's state r−1
  (``convert.fed_mesh_state_from_numpy``) and is handed the reference's
  stumps; its own pick on the same inputs must be the reference's or tie it
  within ``ROUNDING`` in f64 (ROADMAP C4: the reference sums the error
  grid in f32, the port in f64 and rounds once).  Every integer field and
  the interval must equal the reference's in every round.  ``ens_alpha``,
  ``val_margin`` and ``prev_err`` within ``TOL`` (1e-5): the vote kernel's
  plain version sums in another order.  ``D`` within ``D_REL`` (1e-5) of
  itself: the reference multiplies the foreign learners' f32 factors
  exp(−α·y·m), the port takes exp of their sum (the measured gap is about
  2e-6 at M = 64 gathered stumps).
* The port's own run: the reference's summary (280 learners, 10 syncs,
  interval 2 → 8, val_err 0.3550, 40 rounds), or a first split at a
  pick that is a tie, with ``tests/test_fed_mesh.py``'s three criteria
  held.
* The functional scheduler step for step; the gloo form (2 ranks × 4
  clients) bit-equal to one process with 8; ``publish_snapshot`` of the
  converted reference state giving the reference's fingerprint.

``-rP`` prints every tie and the largest gaps.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.paper_fedboost import (  # noqa: E402
    FedBoostConfig, SchedulerConfig)
from repro_torch.convert import (  # noqa: E402
    fed_mesh_state_from_numpy, fed_mesh_state_to_numpy)
from repro_torch.core import fed_mesh, scheduling  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models.weak import stump_thresholds  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
K, ROUNDS, CAP, ENS_CAP = 8, 40, 8, 1024
TOL = 1e-5
D_REL = 1e-5
ROUNDING = 1e-6      # two stumps' exact errors this close tie
INT_FIELDS = ("buf_stamp", "buf_count", "ens_count", "counter", "last_sync",
              "sync_count")
FIELDS = ("D", "buf_params", "buf_stamp", "buf_count", "ens_params",
          "ens_alpha", "ens_count", "val_margin", "interval", "prev_err",
          "counter", "last_sync", "sync_count")

REFERENCE = textwrap.dedent("""
    import os, sys, json, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P, NamedSharding
    from repro.configs.paper_fedboost import FedBoostConfig
    from repro.sim.scenarios import DOMAINS
    from repro.core import fed_mesh
    from repro.data import make_domain_data
    from repro.models.weak import stump_thresholds

    K, R = %(K)d, %(ROUNDS)d
    dom = dataclasses.replace(DOMAINS['edge_vision'], n_clients=K)
    data = make_domain_data(dom, seed=0)
    n_local = min(c[0].shape[0] for c in data['clients'])
    x = jnp.stack([c[0][:n_local] for c in data['clients']])
    y = jnp.stack([c[1][:n_local] for c in data['clients']])
    xv_full, yv_full = data['val']
    nvl = xv_full.shape[0] // K
    xv = xv_full[:K*nvl].reshape(K, nvl, -1)
    yv = yv_full[:K*nvl].reshape(K, nvl)
    mesh = jax.make_mesh((K,), ("clients",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    cfg = FedBoostConfig(n_clients=K)
    thr = stump_thresholds(x.reshape(-1, x.shape[-1]))
    step = fed_mesh.make_fed_boost_step(cfg, mesh, "clients", thr)
    state = fed_mesh.init_state(cfg, K, n_local, nvl, buffer_cap=%(CAP)d,
                                ens_cap=%(ENS_CAP)d, key=jax.random.key(0))
    sh = jax.tree.map(lambda s: NamedSharding(mesh, s),
                      fed_mesh.state_shardings(mesh, "clients"),
                      is_leaf=lambda v: isinstance(v, P))
    dsh = NamedSharding(mesh, P("clients"))
    state = jax.device_put(state, sh)
    x, y, xv, yv = (jax.device_put(a, dsh) for a in (x, y, xv, yv))
    jstep = jax.jit(step)

    def rec(s):
        return {k: np.asarray(v) for k, v in s._asdict().items()
                if k != "key"}
    states = [rec(state)]
    intervals = []
    for r in range(R):
        state = jstep(state, x, y, xv, yv)
        states.append(rec(state))
        intervals.append(float(state.interval))
    out = {f"{r}/{k}": v for r, s in enumerate(states) for k, v in s.items()}
    out.update(x=np.asarray(x), y=np.asarray(y), xv=np.asarray(xv),
               yv=np.asarray(yv), thr=np.asarray(thr))
    np.savez(sys.argv[1], **out)
    print(json.dumps({
        "ens_count": int(state.ens_count),
        "syncs": int(state.sync_count),
        "interval_first": intervals[0],
        "interval_last": intervals[-1],
        "val_err": float(state.prev_err),
        "counter": int(state.counter),
    }))
""") % dict(K=K, ROUNDS=ROUNDS, CAP=CAP, ENS_CAP=ENS_CAP)


def _src_env(**extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **extra)
    env.pop("REPRO_TORCH_KERNEL_BACKEND", None)
    return env


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("fed_mesh") / "reference.npz"
    out = subprocess.run([sys.executable, "-c", REFERENCE, str(path)],
                         env=_src_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    summary = json.loads(out.stdout.strip().splitlines()[-1])
    z = np.load(path)
    states = [{f: z[f"{r}/{f}"] for f in FIELDS} for r in range(ROUNDS + 1)]
    data = tuple(torch.from_numpy(z[k]) for k in ("x", "y", "xv", "yv"))
    return summary, states, data, z["thr"]


def _thresholds(x):
    return stump_thresholds(x.reshape(-1, x.shape[-1]))


def _picks(prev, cur):
    """The stumps the reference fitted in the round from ``prev`` to
    ``cur``, (K, 4): from the buffer, or, where the round synced, from the
    ensemble it was folded into (client-major, slot order)."""
    n = int(prev["counter"]) - int(prev["last_sync"])
    slot = n % CAP
    if int(cur["sync_count"]) == int(prev["sync_count"]):
        return cur["buf_params"][:, slot].copy()
    base, nb = int(prev["ens_count"]), min(n + 1, CAP)
    return np.stack([cur["ens_params"][base + k * nb + slot]
                     for k in range(K)])


def _exact_err(x, y, D, p) -> float:
    """A stump's weighted error on one client in f64."""
    pred = np.where(x[:, int(p[0])] > p[1], 1.0, -1.0) * p[2]
    return float(np.sum(D.astype(np.float64) * (pred != y)))


def _ties(port, ref, x, y, D):
    """The clients whose picks differ, each with its f64 error gap."""
    out = []
    for k in range(K):
        if not np.array_equal(port[k, :3], ref[k, :3]):
            gap = (_exact_err(x[k], y[k], D[k], port[k])
                   - _exact_err(x[k], y[k], D[k], ref[k]))
            out.append((k, port[k].tolist(), ref[k].tolist(), gap))
    return out


def _assert_state(got, want, label):
    gaps = {}
    for f in FIELDS:
        g, w = np.asarray(got[f]), np.asarray(want[f])
        assert g.shape == w.shape, (label, f)
        if f in INT_FIELDS or f == "interval":
            assert np.array_equal(g, w), (label, f, g, w)
        elif f in ("buf_params", "ens_params"):
            # (feature, threshold, polarity) exact; the local eps in f32
            assert np.array_equal(g[..., :3], w[..., :3]), (label, f)
            gaps[f] = float(np.max(np.abs(g[..., 3] - w[..., 3]), initial=0))
            assert gaps[f] <= TOL, (label, f, gaps[f])
        elif f == "D":
            rel = np.abs(g.astype(np.float64) - w) / np.maximum(np.abs(w),
                                                                1e-30)
            gaps[f] = float(rel.max())
            assert gaps[f] <= D_REL, (label, f, gaps[f])
        else:
            gaps[f] = float(np.max(np.abs(g.astype(np.float64) - w),
                                   initial=0))
            assert gaps[f] <= TOL, (label, f, gaps[f])
    return gaps


def test_lockstep_matches_every_round(reference):
    _, states, (x, y, xv, yv), thr = reference
    th = _thresholds(x)
    assert np.array_equal(th.numpy(), thr)
    xn, yn = x.numpy(), y.numpy()
    seen = {}

    def handed(x_, y_, D, thr_k):
        mine, _ = fed_mesh.fit_clients(x_, y_, D, thr_k)
        seen["port"] = mine.numpy()
        p = torch.from_numpy(seen["ref"])
        return p, p[:, 3].contiguous()

    step = fed_mesh.make_fed_boost_step(FedBoostConfig(n_clients=K), th,
                                        fit=handed)
    worst, ties = {}, []
    for r in range(ROUNDS):
        seen["ref"] = _picks(states[r], states[r + 1])
        got = step(fed_mesh_state_from_numpy(states[r]), x, y, xv, yv)
        for k, mine, ref, gap in _ties(seen["port"], seen["ref"], xn, yn,
                                       states[r]["D"]):
            assert abs(gap) <= ROUNDING, (r, k, mine, ref, gap)
            ties.append((r, k, gap))
        for f, g in _assert_state(fed_mesh_state_to_numpy(got),
                                  states[r + 1], f"round {r}").items():
            worst[f] = max(worst.get(f, 0.0), g)
    print(f"lockstep {ROUNDS} rounds: {len(ties)} picks of {ROUNDS * K} "
          f"differ, each a tie (largest f64 gap "
          f"{max((abs(t[2]) for t in ties), default=0):.3g}); "
          f"largest gaps {worst}")
    for r, k, gap in ties:
        print(f"  tie: round {r} client {k}, f64 gap {gap:.3g}")


def test_own_run_gives_the_reference_or_splits_at_a_tie(reference):
    summary, states, (x, y, xv, yv), _ = reference
    cfg = FedBoostConfig(n_clients=K)
    seen = {}

    def fit(*args):
        seen["p"], eps = fed_mesh.fit_clients(*args)
        return seen["p"], eps

    step = fed_mesh.make_fed_boost_step(cfg, _thresholds(x), fit=fit)
    s = fed_mesh.init_state(cfg, K, x.shape[1], xv.shape[1], CAP, ENS_CAP,
                            device="cpu")
    intervals, split = [], None
    for r in range(ROUNDS):
        D = s.D.numpy()
        on_ref = split is None and all(
            np.array_equal(v, states[r][f])
            for f, v in fed_mesh_state_to_numpy(s).items()
            if f in INT_FIELDS)
        s = step(s, x, y, xv, yv)
        intervals.append(float(s.interval))
        if on_ref and split is None:
            ties = _ties(seen["p"].numpy(),
                         _picks(states[r], states[r + 1]),
                         x.numpy(), y.numpy(), D)
            if ties:
                split = (r, ties)
    got = {"ens_count": s.ens_count, "syncs": s.sync_count,
           "interval_first": intervals[0], "interval_last": intervals[-1],
           "val_err": float(s.prev_err), "counter": s.counter}
    print(f"reference {summary}\nport      {got}")
    if split is not None:
        r, ties = split
        print(f"first split at round {r}: {ties}")
        assert all(abs(t[3]) <= ROUNDING for t in ties), ties
    else:
        assert got == pytest.approx(summary, abs=1e-7)
    # tests/test_fed_mesh.py's criteria, on the port's own run
    assert got["val_err"] < 0.38
    assert got["interval_last"] > got["interval_first"]
    assert 0 < got["syncs"] < got["counter"] and got["ens_count"] > 0


def test_scheduler_step_for_step():
    import jax.numpy as jnp
    from repro.configs.paper_fedboost import SchedulerConfig as JSC
    from repro.core import scheduling as js
    rng = np.random.RandomState(0)
    for over in ({}, {"i_init": 0, "alpha": 0.5, "beta": 1.5},
                 {"i_init": 12, "i_max": 6, "theta1": -0.01}):
        cfg, jcfg = SchedulerConfig(**over), JSC(**over)
        st, jst = scheduling.init_state(cfg), js.init_state(jcfg)
        errs = np.concatenate([rng.uniform(0, 0.5, 40),
                               np.full(5, 0.25), [0.3, 0.29, 0.2905]])
        for e in errs.astype(np.float32):
            st = scheduling.adapt_interval(st, e, cfg)
            jst = js.adapt_interval(jst, jnp.float32(e), jcfg)
            assert st.interval.dtype == torch.float32
            assert np.float32(st.interval) == np.float32(jst.interval)
            assert np.float32(st.prev_error) == np.float32(jst.prev_error)
            assert st.initialized == bool(jst.initialized)


def test_foreign_update_exp_of_sum_holds_the_product():
    """exp(−y·Σ α·m) through the vote against the reference's product of
    M f32 factors, at the edge_vision cut's M = 64 and a wider M."""
    rng = np.random.RandomState(1)
    for Kc, M, n in ((8, 64, 40), (4, 1024, 200)):
        xsel = torch.from_numpy(rng.randn(Kc, M, n).astype(np.float32))
        thr = torch.from_numpy(rng.randn(M).astype(np.float32) * 0.5)
        pol = torch.from_numpy(np.where(rng.rand(M) < 0.5, 1.0, -1.0)
                               .astype(np.float32))
        a = torch.from_numpy(rng.uniform(0, 0.2, (Kc, M)).astype(np.float32))
        a[:, ::7] = 0.0                           # own and invalid learners
        y = torch.from_numpy(np.where(rng.rand(Kc, n) < 0.5, 1.0, -1.0)
                             .astype(np.float32))
        s = ops.stump_vote_batched(xsel, thr.expand(Kc, M), pol.expand(Kc, M),
                                   a)
        got = torch.exp(-y * s)
        m = fed_mesh._stump_margins(xsel, thr, pol)
        want = torch.prod(torch.exp(-a[:, :, None] * y[:, None, :] * m),
                          dim=1)
        rel = float(((got - want).abs() / want).max())
        print(f"K={Kc} M={M}: exp of the sum within {rel:.3g} of the "
              f"product")
        assert rel <= D_REL * (M / 64)


def _mesh_data(k):
    import dataclasses
    from repro_torch.data import make_domain_data
    from repro_torch.sim.scenarios import DOMAINS
    data = make_domain_data(dataclasses.replace(DOMAINS["edge_vision"],
                                                n_clients=k), seed=0)
    n_local = min(c[0].shape[0] for c in data["clients"])
    x = np.stack([c[0][:n_local] for c in data["clients"]])
    y = np.stack([c[1][:n_local] for c in data["clients"]])
    xv, yv = data["val"]
    nvl = xv.shape[0] // k
    return (x, y, xv[:k * nvl].reshape(k, nvl, -1),
            yv[:k * nvl].reshape(k, nvl))


GLOO = textwrap.dedent("""
    import sys, numpy as np, torch, torch.distributed as dist
    from repro_torch.configs.paper_fedboost import FedBoostConfig
    from repro_torch.convert import fed_mesh_state_to_numpy
    from repro_torch.core import fed_mesh
    from repro_torch.models.weak import stump_thresholds
    rank, world, port, src, out = (int(sys.argv[1]), int(sys.argv[2]),
                                   sys.argv[3], sys.argv[4], sys.argv[5])
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    z = np.load(src)
    K = z["x"].shape[0]
    k = K // world
    x, y, xv, yv = (torch.from_numpy(z[n][rank * k:(rank + 1) * k])
                    for n in ("x", "y", "xv", "yv"))
    thr = stump_thresholds(torch.from_numpy(z["x"]).reshape(
        -1, z["x"].shape[-1]))
    cfg = FedBoostConfig(n_clients=K)
    step = fed_mesh.make_fed_boost_step(cfg, thr, group=dist.group.WORLD)
    s = fed_mesh.init_state(cfg, k, x.shape[1], xv.shape[1], %(CAP)d,
                            %(ENS_CAP)d, device="cpu")
    for r in range(%(ROUNDS)d):
        s = step(s, x, y, xv, yv)
    np.savez(f"{out}.{rank}.npz", **fed_mesh_state_to_numpy(s))
    dist.destroy_process_group()
""") % dict(CAP=CAP, ENS_CAP=ENS_CAP, ROUNDS=ROUNDS)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("world", [2, 4])
def test_gloo_group_is_bit_equal_to_one_process(tmp_path, world):
    """K = 8 clients over 2 or 4 gloo ranks (4: two clients a rank, the
    four-card layout's form), each rank's state bit-equal to its share of
    one process's after every round's gathers and sums."""
    x, y, xv, yv = _mesh_data(K)
    src = tmp_path / "data.npz"
    np.savez(src, x=x, y=y, xv=xv, yv=yv)
    port, out = _free_port(), tmp_path / "state"
    procs = [subprocess.Popen([sys.executable, "-c", GLOO, str(r),
                               str(world), str(port), str(src), str(out)],
                              env=_src_env(OMP_NUM_THREADS="1"),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for r in range(world)]
    for p in procs:
        _, err = p.communicate(timeout=180)
        assert p.returncode == 0, err[-3000:]

    tx, ty, txv, tyv = map(torch.from_numpy, (x, y, xv, yv))
    cfg = FedBoostConfig(n_clients=K)
    step = fed_mesh.make_fed_boost_step(cfg, _thresholds(tx))
    s = fed_mesh.init_state(cfg, K, x.shape[1], xv.shape[1], CAP, ENS_CAP,
                            device="cpu")
    for _ in range(ROUNDS):
        s = step(s, tx, ty, txv, tyv)
    want = fed_mesh_state_to_numpy(s)
    ranks = [np.load(f"{out}.{r}.npz") for r in range(world)]
    split = fed_mesh.state_shardings()
    for f, w in want.items():
        if getattr(split, f) is None:
            for z in ranks:
                assert np.array_equal(z[f], w), f
        else:
            got = np.concatenate([z[f] for z in ranks])
            assert got.dtype == w.dtype and np.array_equal(got, w), f
    print(f"gloo {world}x{K // world}: {s.sync_count} syncs, {s.ens_count} "
          f"learners, bit-equal to one process")


def test_publish_snapshot_gives_the_reference_fingerprint(reference):
    import jax.numpy as jnp
    from repro.core import fed_mesh as jfm
    from repro.serve.registry import EnsembleRegistry as JRegistry
    from repro_torch import obs
    from repro_torch.serve import EnsembleRegistry, ShardCluster
    _, states, _, _ = reference
    final = states[-1]
    jstate = jfm.FedMeshState(**{f: jnp.asarray(v) for f, v in final.items()},
                              key=None)
    want = jfm.publish_snapshot(jstate, JRegistry(), "edge_vision",
                                clock=3.5)
    state = fed_mesh_state_from_numpy(final)
    reg = obs.set_registry(obs.MetricsRegistry())
    try:
        got = fed_mesh.publish_snapshot(state, EnsembleRegistry(),
                                        "edge_vision", clock=3.5)
        cluster = ShardCluster(3)
        sharded = fed_mesh.publish_snapshot(state, cluster, "edge_vision",
                                            clock=3.5)
        publishes = obs.get_registry().counter("train.publishes").value
    finally:
        obs.set_registry(reg)
    assert got.fingerprint == want.fingerprint
    assert sharded.fingerprint == want.fingerprint
    assert cluster.latest("edge_vision").version == 1
    assert (got.version, got.train_progress, got.published_at) == (
        want.version, want.train_progress, want.published_at)
    assert len(got.alphas) == int(final["ens_count"]) == 280
    assert publishes == 2
