"""The port's scenario serve replay against the JAX package's, on the CPU.

Reduced scenarios (the shard size cut as the JAX package's
``tests/test_sim.py`` cuts edge_vision/rack_outage for its harness test)
are trained by the JAX package into its sharded cluster.  That cluster's
windows are carried across with ``convert.shard_cluster_from_numpy`` and
both packages replay the same request trace from the same cluster state:
every field of the replay report must be equal (floats to 1e-9 relative:
Python arithmetic on the same modeled times), every response's rid,
tenant, version and submit time equal, and its margin within rtol/atol
1e-5.  The port's own train->serve run must give the same report but for
``snapshot_version``, which may differ only where the enhanced runs'
counters split at an exact stump tie (ROADMAP C4).  The fleet's zero-loss
invariant holds in both.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve import GossipConfig as JaxGossip  # noqa: E402
from repro.serve import ShardCluster as JaxCluster  # noqa: E402
from repro.sim import harness as jharness  # noqa: E402
from repro.sim import scenarios as jscen  # noqa: E402
from repro_torch.convert import (cluster_windows,  # noqa: E402
                                 shard_cluster_from_numpy)
from repro_torch.serve import GossipConfig  # noqa: E402
from repro_torch.sim import harness as tharness  # noqa: E402
from repro_torch.sim import scenarios as tscen  # noqa: E402

TOL = 1e-5
REL = 1e-9
# (scenario, trace, samples, clients, rounds, replay seconds): the shard
# sizes cut to keep the JAX package's side of this file near 30 s
CASES = [("edge_vision", "rack_outage", 500, 4, 4, 0.5),
         ("iot", "gilbert", 600, 6, 3, 0.6),
         ("healthcare", "maintenance", 500, 4, 4, 1.0)]


def _small(module, name, n_samples, n_clients):
    sc = module.get_scenario(name)
    return dataclasses.replace(sc, domain=dataclasses.replace(
        sc.domain, n_samples=n_samples, n_clients=n_clients))


def _recording(monkeypatch, harness):
    """Record every response the harness's fleet hands back (submits,
    scale-in drains, the final drain), in order."""
    seen = []
    base = harness.ShardedEnsembleServer

    class Recording(base):
        def submit(self, tenant, x, now):
            ok, out = super().submit(tenant, x, now)
            seen.extend(out)
            return ok, out

        def remove_host(self, host_id, now=0.0):
            out, n = super().remove_host(host_id, now)
            seen.extend(out)
            return out, n

        def drain(self):
            out = super().drain()
            seen.extend(out)
            return out
    monkeypatch.setattr(harness, "ShardedEnsembleServer", Recording)
    return seen


def assert_serve_equal(got, want, skip=()):
    assert got.keys() == want.keys()
    for k, w in want.items():
        if k in skip:
            continue
        g = got[k]
        if isinstance(w, float):
            assert math.isclose(g, w, rel_tol=REL, abs_tol=0.0), (k, g, w)
        else:
            assert g == w, (k, g, w)


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def reference(request):
    name, trace, n, k, rounds, duration = request.param
    sc = _small(jscen, name, n, k)
    cluster = JaxCluster(2, JaxGossip(seed=0))
    data, runs = jharness.train_pair(sc, trace, seed=0, n_rounds=rounds,
                                     cluster=cluster)
    windows = cluster_windows(cluster)
    rng_state = cluster._rng.getstate()
    mp = pytest.MonkeyPatch()
    try:
        seen = _recording(mp, jharness)
        serve = jharness.replay_serve(sc, cluster, data, trace, seed=0,
                                      duration_s=duration)
    finally:
        mp.undo()
    return dict(case=request.param, data=data, runs=runs, windows=windows,
                rng_state=rng_state, serve=serve, responses=list(seen))


def test_replay_from_the_reference_cluster_equals_reference(reference,
                                                            monkeypatch):
    name, trace, n, k, rounds, duration = reference["case"]
    sc = _small(tscen, name, n, k)
    cluster = shard_cluster_from_numpy(reference["windows"],
                                       GossipConfig(seed=0),
                                       rng_state=reference["rng_state"])
    data = {"test": tuple(np.asarray(a) for a in reference["data"]["test"])}
    seen = _recording(monkeypatch, tharness)
    serve = tharness.replay_serve(sc, cluster, data, trace, seed=0,
                                  duration_s=duration, device="cpu")
    want = reference["serve"]
    assert_serve_equal(serve, want)
    assert serve["completed"] > 0 and serve["snapshot_version"] > 0
    assert serve["completed"] + serve["rejected"] == serve["offered"]
    ref = reference["responses"]
    assert len(seen) == len(ref) == serve["completed"]
    for a, b in zip(ref, seen):
        assert (a.rid, a.tenant, a.snapshot_version, a.t_submit) == (
            b.rid, b.tenant, b.snapshot_version, b.t_submit)
        assert abs(a.margin - b.margin) <= TOL + TOL * abs(a.margin)
    rids = [r.rid for r in seen]
    assert len(set(rids)) == len(rids)       # answered exactly once


def test_arrivals_are_the_reference_trace(reference):
    """The replay's request trace (times, features, offline count) is a
    function of the behavior models and the request RNG alone."""
    name, trace, n, k, rounds, duration = reference["case"]
    sc = _small(tscen, name, n, k)
    data = {"test": tuple(np.asarray(a) for a in reference["data"]["test"])}
    arrivals, offline = tharness._serve_arrivals(sc, data, trace, 0,
                                                 duration)
    assert len(arrivals) == reference["serve"]["offered"]
    assert offline == reference["serve"]["offline_suppressed"]
    assert [t for t, _ in arrivals] == sorted(t for t, _ in arrivals)
    submits = sorted(r.t_submit for r in reference["responses"])
    assert sorted(t for t, _ in arrivals) == submits


def test_own_train_serve_run_equals_reference(reference):
    name, trace, n, k, rounds, duration = reference["case"]
    rep = tharness.run_scenario(_small(tscen, name, n, k), trace=trace,
                                seed=0, n_rounds=rounds,
                                serve_duration_s=duration, device="cpu")
    want = reference["serve"]
    assert_serve_equal(rep.serve, want, skip=("snapshot_version",))
    jm, tm = reference["runs"]["enhanced"], rep.enhanced
    counters = ("total_bytes", "n_messages", "n_syncs", "learners_merged",
                "snapshots_published")
    if all(getattr(jm, c) == getattr(tm, c) for c in counters):
        assert rep.serve["snapshot_version"] == want["snapshot_version"]
    assert rep.serve["snapshot_version"] == tm.snapshots_published > 0
    for c in counters:                        # baseline: learning-free
        assert (getattr(rep.baseline, c)
                == getattr(reference["runs"]["baseline"], c)), c
    assert "serve:" in tharness.summarize(rep)


def test_replay_without_autoscale_and_on_three_hosts():
    sc = _small(tscen, "edge_vision", 500, 4)
    fixed = tharness.run_scenario(sc, trace="rack_outage", n_rounds=3,
                                  serve_duration_s=0.4, hosts=3,
                                  autoscale=False, device="cpu")
    s = fixed.serve
    assert s["hosts_final"] == 3
    assert (s["scale_outs"], s["scale_ins"], s["rerouted"]) == (0, 0, 0)
    assert s["completed"] + s["rejected"] == s["offered"] > 0
    jsc = _small(jscen, "edge_vision", 500, 4)
    want = jharness.run_scenario(jsc, trace="rack_outage", n_rounds=3,
                                 serve_duration_s=0.4, hosts=3,
                                 autoscale=False).serve
    assert_serve_equal(s, want, skip=("snapshot_version",))


def test_replay_under_load_scales_and_loses_nothing():
    """A replay that drives the autoscaler through churn: the zero-loss
    assertion inside the replay holds, and the churn equals the JAX
    package's."""
    def loud(module):
        sc = _small(module, "iot", 600, 6)
        return dataclasses.replace(sc, serve_rate=5000.0)
    rep = tharness.run_scenario(loud(tscen), trace="gilbert", n_rounds=2,
                                serve_duration_s=0.5, device="cpu")
    want = jharness.run_scenario(loud(jscen), trace="gilbert", n_rounds=2,
                                 serve_duration_s=0.5).serve
    assert_serve_equal(rep.serve, want, skip=("snapshot_version",))
    assert rep.serve["scale_outs"] >= 1
