"""The port's sharded registry and fleet front door against the JAX
package's, on the CPU.

Both packages' clusters take the same publishes (synthetic packed stumps
from numpy) and the same gossip seed; rendezvous owners and ranks, digests,
``GossipStats`` after every round, rounds to quiescence, reconciliation
winners, failover routes and fleet reports must be equal, and served
margins within rtol/atol 1e-5 (the votes' f32 sums differ in order only).
Each criterion of the JAX package's ``tests/test_serve_shard.py`` is run
on both packages side by side: the port must meet it and give the
reference's observable outcome.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.serve as J  # noqa: E402
import repro_torch.serve as T  # noqa: E402
from repro_torch.convert import (cluster_windows,  # noqa: E402
                                 shard_cluster_from_numpy)

TOL = 1e-5
PORT_KW = {"device": "cpu"}


def _publish(target, tenant, T_=4, F=6, seed=0, clock=0.0, progress=0):
    rng = np.random.RandomState(seed)
    p = np.zeros((T_, 4), np.float32)
    p[:, 0] = rng.randint(0, F, size=T_)
    p[:, 1] = rng.randn(T_)
    p[:, 2] = np.where(rng.rand(T_) > 0.5, 1.0, -1.0)
    a = (rng.rand(T_) + 0.1).astype(np.float32)
    return target.publish_packed(tenant, p, a, clock=clock,
                                 train_progress=progress)


def both(fn):
    """``fn(serve_module, server_kw)`` run on the JAX package and the port."""
    return fn(J, {}), fn(T, PORT_KW)


def assert_responses_equal(ref, port):
    assert len(ref) == len(port)
    for a, b in zip(ref, port):
        assert (a.rid, a.tenant, a.snapshot_version, a.t_submit) == (
            b.rid, b.tenant, b.snapshot_version, b.t_submit)
        assert abs(a.margin - b.margin) <= TOL + TOL * abs(a.margin)
        if abs(a.margin) > TOL:
            assert a.label == b.label


def assert_cluster_equal(jc, tc):
    assert jc.digests() == tc.digests()
    assert dataclasses.asdict(jc.stats) == dataclasses.asdict(tc.stats)
    assert jc.host_ids(up_only=False) == tc.host_ids(up_only=False)
    assert jc.host_ids() == tc.host_ids()
    for hid in jc.hosts:
        jr, tr = jc.hosts[hid].registry, tc.hosts[hid].registry
        assert jr.tenants() == tr.tenants()
        for t in jr.tenants():
            assert ([(s.version, s.published_at, s.fingerprint)
                     for s in jr.history(t)]
                    == [(s.version, s.published_at, s.fingerprint)
                        for s in tr.history(t)])


# ---------------------------------------------------------------- routing
@pytest.mark.parametrize("n_hosts", [1, 2, 3, 5, 8])
def test_rendezvous_owner_and_rank_equal_reference(n_hosts):
    rng = np.random.RandomState(n_hosts)
    for trial in range(4):
        hosts = [f"h{rng.randint(10_000)}-{i}" for i in range(n_hosts)]
        for t in [f"tenant-{i}" for i in range(60)] + ["iot", "mobile_x4"]:
            assert T.rendezvous_owner(t, hosts) == J.rendezvous_owner(
                t, hosts)
            assert T.rendezvous_rank(t, hosts) == J.rendezvous_rank(t, hosts)


def test_rendezvous_deterministic_and_minimally_disruptive():
    hosts = [f"h{i}" for i in range(5)]
    tenants = [f"tenant-{i}" for i in range(40)]
    owners = {t: T.rendezvous_owner(t, hosts) for t in tenants}
    assert owners == {t: J.rendezvous_owner(t, hosts) for t in tenants}
    assert len(set(owners.values())) > 1
    survivors = [h for h in hosts if h != "h2"]
    for t in tenants:
        new = T.rendezvous_owner(t, survivors)
        assert new == J.rendezvous_owner(t, survivors)
        if owners[t] != "h2":
            assert new == owners[t]           # only h2's tenants move
        else:
            assert new != "h2"
    rank = T.rendezvous_rank(tenants[0], hosts)
    assert rank[0] == owners[tenants[0]] and sorted(rank) == sorted(hosts)


def test_staleness_weight_and_reconcile_score_equal_reference():
    for dt in (-3.0, 0.0, 0.1, 1.0, 2.0, 5.0, 40.0):
        for lam in (0.0, 0.5, 2.0):
            assert (T.staleness_weight(dt, lam)
                    == J.staleness_weight(dt, lam))
    assert T.staleness_weight(0.0, 0.5) == 1.0
    assert (T.staleness_weight(1.0, 0.5) > T.staleness_weight(2.0, 0.5)
            > T.staleness_weight(5.0, 0.5) > 0.0)
    assert T.staleness_weight(-3.0, 0.5) == 1.0
    from repro.serve.shard import reconcile_score as jscore
    from repro_torch.serve.shard import reconcile_score as tscore
    js = _publish(J.EnsembleRegistry(), "t", seed=3, clock=1.5, progress=7)
    ts = _publish(T.EnsembleRegistry(), "t", seed=3, clock=1.5, progress=7)
    assert js.fingerprint == ts.fingerprint
    for now in (0.0, 1.5, 4.0):
        assert tscore(ts, now, 0.5) == jscore(js, now, 0.5)


# ----------------------------------------------------------------- gossip
def _publish_sequence(P, _kw):
    """Publishes, a race, an outage and a recovery, gossiping between: the
    cluster's state and stats after every step."""
    c = P.ShardCluster(4, P.GossipConfig(seed=0, history=3))
    trail = []

    def snap(label):
        trail.append((label, c.digests(), dataclasses.asdict(c.stats),
                      c.converged()))
    for i, t in enumerate(["a", "b", "c", "d", "e"]):
        _publish(c, t, seed=i, clock=0.1 * i, progress=i)
    snap("published")
    for r in range(3):
        c.gossip_round(now=1.0 + r)
        snap(f"round {r}")
    for v in range(4):                           # a's window slides
        _publish(c, "a", T_=5 + v, seed=10 + v, clock=2.0 + v, progress=9)
    # a genuine race on b: two hosts publish the same next version
    h = c.host_ids()
    _publish(c.hosts[h[0]].registry, "b", seed=20, clock=3.0, progress=3)
    _publish(c.hosts[h[1]].registry, "b", seed=21, clock=3.5, progress=30)
    snap("raced")
    rounds = c.run_until_quiescent(now=4.0)
    snap(f"quiescent in {rounds}")
    c.mark_down(c.owner("c"))
    _publish(c, "c", T_=7, seed=30, clock=5.0)
    snap("published during outage")
    for hid in c.host_ids(up_only=False):
        c.mark_up(hid)
    rounds = c.run_until_quiescent(now=6.0)
    snap(f"recovered in {rounds}")
    return c, trail


def test_gossip_digests_stats_and_quiescence_equal_reference():
    (jc, jtrail), (tc, ttrail) = both(_publish_sequence)
    assert [t[0] for t in ttrail] == [t[0] for t in jtrail]
    for j, t in zip(jtrail, ttrail):
        assert t == j, j[0]
    assert ttrail[-1][3] and ttrail[-1][0] == jtrail[-1][0]
    assert_cluster_equal(jc, tc)


def test_gossip_pull_on_miss_replicates_history_window():
    def run(P, _kw):
        cluster = P.ShardCluster(3, P.GossipConfig(seed=3, history=3))
        for v in range(5):
            _publish(cluster, "t", T_=3 + v, seed=v, clock=float(v))
        rounds = cluster.run_until_quiescent(now=5.0)
        return cluster, rounds
    (jc, jr), (tc, tr) = both(run)
    assert tr == jr and tc.converged()
    assert_cluster_equal(jc, tc)
    for host in tc.hosts.values():
        assert [s.version for s in host.registry.history("t")] == [3, 4, 5]
        assert host.registry.latest("t").n_learners == 7
        assert host.registry.get("t", 4).n_learners == 6


@pytest.mark.parametrize("lam,clocks,progress", [
    (0.5, (0.0, 3.0), (5, 30)),       # fresher and more trained wins
    (0.5, (3.0, 0.0), (30, 5)),       # the same, the other way round
    (0.0, (1.0, 1.0), (4, 4)),        # an exact tie: fingerprint decides
    (2.0, (0.0, 0.5), (40, 2)),       # more trained but staler
])
def test_concurrent_version_tiebreak_equal_reference(lam, clocks, progress):
    def run(P, _kw):
        cluster = P.ShardCluster(2, P.GossipConfig(seed=0, lam=lam))
        h0, h1 = cluster.hosts.values()
        a = _publish(h0.registry, "t", seed=1, clock=clocks[0],
                     progress=progress[0])
        b = _publish(h1.registry, "t", seed=2, clock=clocks[1],
                     progress=progress[1])
        assert a.version == b.version == 1            # a genuine race
        cluster.run_until_quiescent(now=3.0)
        return cluster, (a.fingerprint, b.fingerprint)
    (jc, jfp), (tc, tfp) = both(run)
    assert tfp == jfp
    assert_cluster_equal(jc, tc)
    winners = {h.registry.latest("t").fingerprint for h in tc.hosts.values()}
    assert len(winners) == 1 and tc.stats.reconciled >= 1
    if (lam, progress) == (0.5, (5, 30)):
        assert winners == {tfp[1]}


def test_publish_routes_to_owner_and_facade_reads():
    def run(P, _kw):
        cluster = P.ShardCluster(3, P.GossipConfig(seed=0))
        snap = _publish(cluster, "t", clock=2.0)
        return cluster, snap
    (jc, js), (tc, ts) = both(run)
    owner = tc.owner("t")
    assert owner == jc.owner("t") and ts.fingerprint == js.fingerprint
    assert tc.hosts[owner].registry.latest("t") is ts
    for hid, host in tc.hosts.items():
        if hid != owner:
            assert host.registry.latest("t") is None
    assert tc.latest("t") is ts and tc.get("t", 1) is ts
    assert tc.version_count("t") == 1
    assert tc.staleness("t", 3.5) == pytest.approx(1.5)
    assert tc.tenants() == ["t"]


def test_engine_publish_notifies_owning_shard():
    """The engines' publish hooks, pointed at clusters, land the same
    snapshots on the same owning shard."""
    from repro.configs.paper_fedboost import FedBoostConfig as JCfg
    from repro.core import FederatedBoostEngine as JEngine
    from repro.data import make_domain_data
    from repro.sim.scenarios import DOMAINS
    from repro_torch.configs.paper_fedboost import FedBoostConfig
    from repro_torch.convert import domain_data_from_numpy
    from repro_torch.core import FederatedBoostEngine
    dom = dataclasses.replace(DOMAINS["edge_vision"], n_samples=400,
                              n_clients=3)
    jdata = make_domain_data(dom, seed=0)
    data = domain_data_from_numpy(jdata["clients"], jdata["val"],
                                  jdata["test"])
    kw = dict(n_clients=3, n_rounds=4, seed=0)
    jc = J.ShardCluster(3, J.GossipConfig(seed=0))
    tc = T.ShardCluster(3, T.GossipConfig(seed=0))
    je = JEngine(JCfg(**kw), jdata, "enhanced")
    je.attach_registry(jc, "edge_vision")
    jm = je.run()
    te = FederatedBoostEngine(FedBoostConfig(**kw), data, "enhanced",
                              device="cpu")
    te.attach_registry(tc, "edge_vision")
    tm = te.run()
    assert tm.snapshots_published == jm.snapshots_published >= 1
    owner = tc.owner("edge_vision")
    assert owner == jc.owner("edge_vision")
    assert (tc.hosts[owner].registry.version_count("edge_vision")
            == tm.snapshots_published)
    for hid, host in tc.hosts.items():
        if hid != owner:
            assert host.registry.latest("edge_vision") is None
    assert tc.digests().keys() == jc.digests().keys()


# --------------------------------------------------------------- failover
def test_failover_serves_from_gossiped_replica_and_recovers():
    x = np.random.RandomState(1).randn(6).astype(np.float32)

    def run(P, kw):
        cluster = P.ShardCluster(3, P.GossipConfig(seed=0))
        snap = _publish(cluster, "t", seed=4)
        cluster.run_until_quiescent()
        server = P.ShardedEnsembleServer(
            cluster, P.BatchConfig(cache_capacity=64),
            service_model=lambda n: 1e-4, **kw)

        def roundtrip(now):
            _, out = server.submit("t", x, now)
            out += server.drain()
            (resp,) = out
            return resp
        before = roundtrip(0.0)
        owner = cluster.owner("t")
        cluster.mark_down(owner)
        backup = cluster.route("t").host_id
        after = roundtrip(1.0)
        v2 = _publish(cluster, "t", T_=6, seed=9, clock=2.0)
        cluster.mark_up(owner)
        rounds = cluster.run_until_quiescent(now=2.0)
        return dict(cluster=cluster, snap=snap, owner=owner, backup=backup,
                    responses=[before, after], v2=v2.version, rounds=rounds,
                    report=server.report())
    j, t = both(run)
    assert (t["owner"], t["backup"], t["v2"], t["rounds"]) == (
        j["owner"], j["backup"], j["v2"], j["rounds"])
    assert t["backup"] != t["owner"]
    before, after = t["responses"]
    assert after.margin == before.margin
    assert after.snapshot_version == t["snap"].version
    assert_responses_equal(j["responses"], t["responses"])
    assert t["cluster"].hosts[t["owner"]].registry.latest("t").version == 2
    assert t["cluster"].converged()
    assert_cluster_equal(j["cluster"], t["cluster"])
    assert t["report"] == j["report"]


def test_all_hosts_down_sheds_load():
    def run(P, kw):
        cluster = P.ShardCluster(2, P.GossipConfig(seed=0))
        _publish(cluster, "t")
        server = P.ShardedEnsembleServer(cluster, P.BatchConfig(),
                                         service_model=lambda n: 1e-4, **kw)
        for hid in list(cluster.hosts):
            cluster.mark_down(hid)
        first = server.submit("t", np.zeros(6, np.float32), 0.0)
        with pytest.raises(RuntimeError):
            cluster.owner("t")
        server.submit("other", np.zeros(6, np.float32), 0.0)
        return first, server.report()
    (jfirst, jrep), (tfirst, trep) = both(run)
    assert tfirst == jfirst == (False, [])
    assert trep == jrep
    assert trep["rejected"] == 2 and trep["completed"] == 0
    assert trep["tenants"]["t"]["rejected"] == 1
    assert trep["tenants"]["other"]["rejected"] == 1


def test_report_merges_mixed_up_down_fleet():
    tenants = ["a", "b", "c", "d"]

    def run(P, kw):
        cluster = P.ShardCluster(3, P.GossipConfig(seed=0))
        for i, t in enumerate(tenants):
            _publish(cluster, t, seed=i)
        _publish(cluster, "a", T_=6, seed=9)
        cluster.run_until_quiescent()
        server = P.ShardedEnsembleServer(
            cluster, P.BatchConfig(cache_capacity=64, adaptive=False,
                                   fixed_window_units=1),
            service_model=lambda n: 1e-4, **kw)
        rng = np.random.RandomState(0)
        pools = {t: rng.randn(4, 6).astype(np.float32) for t in tenants}
        accepted, responses = 0, []
        for i in range(48):
            if i == 24:
                victim = cluster.owner("a")
                cluster.mark_down(victim)
            t = tenants[i % 4]
            ok, out = server.submit(t, pools[t][i % 4], now=1e-3 * i)
            accepted += ok
            responses += out
        responses += server.drain()
        hits = sum(s.cache.stats.hits for s in server.servers.values())
        return accepted, victim, responses, server.report(), hits
    j, t = both(run)
    accepted, victim, responses, rep, hits = t
    assert (accepted, victim) == j[:2]
    assert_responses_equal(j[2], responses)
    assert rep == j[3]
    assert accepted == 48 and rep["completed"] == 48
    per_host = rep["per_host"]
    assert rep["completed"] == sum(h["completed"] for h in per_host.values())
    assert rep["n_batches"] == sum(h["n_batches"] for h in per_host.values())
    statuses = {hid: h["status"] for hid, h in per_host.items()}
    assert statuses[victim] == "down"
    assert sorted(statuses.values()) == ["down", "up", "up"]
    assert rep["tenants"]["a"]["snapshot_version"] == 2
    assert rep["tenants"]["a"]["completed"] == 12
    assert sum(x["completed"] for x in rep["tenants"].values()) == 48
    cache = rep["cache"]
    assert cache["hits"] + cache["misses"] > 0 and cache["hits"] == hits
    assert cache["hit_rate"] == pytest.approx(
        cache["hits"] / (cache["hits"] + cache["misses"]))


def test_fleet_rids_unique_across_hosts():
    def run(P, kw):
        cluster = P.ShardCluster(3, P.GossipConfig(seed=0))
        for i, t in enumerate("abcd"):
            _publish(cluster, t, seed=i)
        owners = {cluster.owner(t) for t in "abcd"}
        server = P.ShardedEnsembleServer(cluster, P.BatchConfig(),
                                         service_model=lambda n: 1e-4, **kw)
        rng = np.random.RandomState(0)
        responses = []
        for i in range(40):
            _, done = server.submit("abcd"[i % 4],
                                    rng.randn(6).astype(np.float32),
                                    now=1e-3 * i)
            responses += done
        responses += server.drain()
        return owners, responses
    (jo, jr), (to, tr) = both(run)
    assert to == jo and len(to) > 1
    assert_responses_equal(jr, tr)
    rids = [r.rid for r in tr]
    assert len(rids) == 40 and len(set(rids)) == 40


# ------------------------------------------------- membership hand-offs
def test_add_and_remove_host_hand_windows_over_like_reference():
    tenants = [f"t{i}" for i in range(6)]

    def run(P, _kw):
        cluster = P.ShardCluster(3, P.GossipConfig(seed=0))
        for i, t in enumerate(tenants):
            _publish(cluster, t, seed=i)
        cluster.run_until_quiescent()
        steps = []
        new = cluster.add_host("h-new", now=1.0)
        steps.append((new.up, new.registry.digest(), cluster.host_ids()))
        owner = cluster.owner("t0")
        _publish(cluster, "t0", T_=5, seed=9, clock=2.0)   # owner only
        cluster.remove_host(owner, now=2.0)
        steps.append((owner, cluster.digests(),
                      dataclasses.asdict(cluster.stats)))
        steps.append(cluster.run_until_quiescent(now=3.0))
        for hid in list(cluster.hosts):
            cluster.mark_down(hid)
        repl = cluster.add_host("replacement", now=4.0)
        steps.append((repl.registry.digest(), cluster.route("t1").host_id))
        with pytest.raises(ValueError):
            cluster.add_host("replacement")
        return cluster, steps
    (jc, js), (tc, ts) = both(run)
    assert ts == js
    assert_cluster_equal(jc, tc)
    assert ts[0][0] and "h-new" in ts[0][2]
    assert ts[3][1] == "replacement"
    assert tc.converged()


def test_remove_last_host_refuses_and_down_survivor_keeps_window():
    def run(P, _kw):
        cluster = P.ShardCluster(2, P.GossipConfig(seed=0))
        _publish(cluster, "t0", seed=0)
        cluster.run_until_quiescent()
        owner = cluster.owner("t0")
        other = [h for h in cluster.hosts if h != owner][0]
        v2 = _publish(cluster, "t0", T_=5, seed=9)
        cluster.mark_down(other)
        cluster.remove_host(owner)
        with pytest.raises(ValueError):
            cluster.remove_host(other)
        return (other, cluster.hosts[other].registry.latest("t0").fingerprint,
                v2.fingerprint)
    j, t = both(run)
    assert t == j and t[1] == t[2]


def test_cluster_carried_across_replays_like_the_reference():
    """``convert.shard_cluster_from_numpy`` carries a JAX cluster's windows
    (version stamps, publish times, fingerprints) and gossip RNG: both then
    gossip alike."""
    jc = J.ShardCluster(3, J.GossipConfig(seed=5))
    for i, t in enumerate("abc"):
        for v in range(i + 2):
            _publish(jc, t, T_=3 + v, seed=10 * i + v, clock=0.5 * v,
                     progress=v)
    jc.gossip_round(now=1.0)
    windows = cluster_windows(jc)
    tc = shard_cluster_from_numpy(windows, T.GossipConfig(seed=5),
                                  rng_state=jc._rng.getstate())
    assert tc.digests() == jc.digests()
    assert tc.run_until_quiescent(now=2.0) == jc.run_until_quiescent(now=2.0)
    assert tc.digests() == jc.digests()
    bad = dict(windows)
    bad["host-0"] = [dict(bad["host-0"][0], fingerprint="0" * 24)]
    with pytest.raises(ValueError, match="fingerprint"):
        shard_cluster_from_numpy(bad)


def test_merge_of_merges_percentiles_equal_reference():
    """``TenantMetrics.merge_from`` folds like the JAX package's at any
    depth (the JAX package's ``tests/test_obs.py`` merge-of-merges rule):
    totals stay exact, and the pre-merge latency pairs — what the fleet
    report's p50/p99 come from — beat the re-thinned merged reservoir."""
    import random

    from repro.serve.metrics import ServeMetrics as JaxMetrics
    from repro.serve.metrics import percentile as jpercentile
    from repro.serve.metrics import weighted_percentile as jweighted
    from repro_torch.serve.metrics import (ServeMetrics, percentile,
                                           weighted_percentile)

    def fold(metrics_cls, weighted):
        rng = random.Random(7)
        hosts, stream = [], []
        for h in range(4):
            m = metrics_cls()
            base = 0.001 * (h + 1)
            for _ in range(6_000 * (h + 1)):
                v = base * (1.0 + 0.1 * rng.random())
                m.record_completion("t", v, staleness_s=0.0, version=h + 1)
                stream.append(v)
            hosts.append(m)
        pairs = [p for m in hosts for p in m.latency_pairs()]
        lvl = [metrics_cls(), metrics_cls()]
        for i, m in enumerate(hosts):
            lvl[i // 2].tenant("t").merge_from(m.tenant("t"))
        top = metrics_cls()
        for m in lvl:
            top.tenant("t").merge_from(m.tenant("t"))
        return (stream, weighted(pairs, 99.0), top.completed,
                top.fleet_percentile(99.0), top.tenant("t").last_version,
                top.report())
    want = fold(JaxMetrics, jweighted)
    got = fold(ServeMetrics, weighted_percentile)
    assert got[1:] == want[1:]
    stream, flat, completed, merged_p99, version, _ = got
    true_p99 = percentile(stream, 99.0)
    assert true_p99 == jpercentile(stream, 99.0)
    assert completed == len(stream) and version == 4
    assert abs(flat - true_p99) / true_p99 < 0.05
    assert abs(flat - true_p99) <= abs(merged_p99 - true_p99) + 1e-12
