"""The port's chain of record (``repro_torch.chain``) against the JAX
package's, on the CPU.

Each criterion of the JAX package's ``tests/test_chain.py`` (all but its
golden pin, which holds floats of an older JAX) runs on both packages side
by side from the same numpy inputs: the port must meet it and give the
reference's observable outcome.  Commit fingerprints, block hashes, the
committee and its leader, confirmation waits, reorgs, provenance, ledger
pruning and folded snapshot fingerprints must be bit-equal.

A reduced ``blockchain_flchain`` (the JAX package's cut: 500 samples, 4
clients, 4 rounds, a 0.5 s replay) is trained by the JAX package into its
``ChainCluster``; the cluster is carried across with
``convert.chain_to_numpy`` / ``convert.chain_from_numpy`` and both
packages replay the same arrivals from that one state, the committee
leader killed halfway: every report field must be equal, ``killed_host``
included, and every response's rid, tenant and version.  The port's own
train->serve run must give the same report, and the same version where
the enhanced runs' counters agree (ROADMAP C4).
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.chain as J  # noqa: E402
import repro.serve as JS  # noqa: E402
import repro_torch.chain as T  # noqa: E402
import repro_torch.serve as TS  # noqa: E402
from repro.chain.registry import _owner_runs as j_owner_runs  # noqa: E402
from repro.sim import behavior as jbeh  # noqa: E402
from repro.sim import harness as jharness  # noqa: E402
from repro.sim import scenarios as jscen  # noqa: E402
from repro_torch.chain.registry import (  # noqa: E402
    _owner_runs as t_owner_runs)
from repro_torch.convert import (chain_from_numpy,  # noqa: E402
                                 chain_to_numpy, params_from_numpy)
from repro_torch.sim import behavior as tbeh  # noqa: E402
from repro_torch.sim import harness as tharness  # noqa: E402
from repro_torch.sim import scenarios as tscen  # noqa: E402

TOL = 1e-5
REL = 1e-9
CUT = dict(n_samples=500, n_clients=4)      # tests/test_chain.py's cut
ROUNDS, DURATION = 4, 0.5


def both(fn):
    """``fn(chain_module, serve_module)`` on the JAX package, then the
    port."""
    return fn(J, JS), fn(T, TS)


def _commit(mod, seq, tenant="t", cid=0, alphas=(1.0,), rounds=None):
    rows = tuple((float(seq), 0.5, 1.0, 0.0) for _ in alphas)
    return mod.ChainCommit(tenant=tenant, cid=cid, seq=seq,
                           rounds=rounds or (0,) * len(alphas),
                           alphas=tuple(alphas), stump_rows=rows)


def _packed(T_, seed=0):
    rng = np.random.RandomState(seed)
    rows = np.zeros((T_, 4), np.float32)
    rows[:, 0] = rng.randint(0, 6, size=T_)
    rows[:, 1] = rng.randn(T_)
    rows[:, 2] = np.where(rng.rand(T_) > 0.5, 1.0, -1.0)
    return rows, (rng.rand(T_) + 0.1).astype(np.float32)


def blocks(chain):
    """Everything a block records, its hash and its commits' fingerprints
    included."""
    return [(b.height, b.prev_hash, b.mined_at, b.miner, b.hash,
             [(c.seq, c.cid, c.fingerprint) for c in b.commits])
            for b in chain.blocks]


def snaps(reg, tenant):
    return [(s.version, s.published_at, s.train_progress, s.n_learners,
             s.fingerprint) for s in reg.history(tenant)]


# ------------------------------------------------------------- chain core
def test_commit_fingerprint_and_block_hash_equal_reference():
    rng = np.random.RandomState(0)
    for trial in range(20):
        k = 1 + rng.randint(4)
        kw = dict(tenant=f"tenant-{rng.randint(5)}",
                  cid=int(rng.randint(-1, 9)), seq=int(rng.randint(1000)),
                  rounds=tuple(int(r) for r in rng.randint(0, 50, k)),
                  alphas=tuple(float(a) for a in rng.rand(k)),
                  train_progress=int(rng.randint(100)),
                  submitted_at=float(rng.rand() * 10))
        rows = tuple(tuple(np.float32(v) for v in r)
                     for r in rng.randn(k, 4).astype(np.float32))
        jc = J.ChainCommit(stump_rows=rows, **kw)
        tc = T.ChainCommit(stump_rows=rows, **kw)
        assert jc.fingerprint == tc.fingerprint
        h, t = int(rng.randint(1, 99)), float(rng.rand() * 100)
        assert (J.block_hash(h, J.GENESIS_HASH, t, [jc, jc])
                == T.block_hash(h, T.GENESIS_HASH, t, [tc, tc]))
    assert T.GENESIS_HASH == J.GENESIS_HASH
    assert (J.Block(0, J.GENESIS_HASH, 0.0).hash
            == T.Block(0, T.GENESIS_HASH, 0.0).hash)


def test_generic_commit_fingerprint_equals_reference():
    rng = np.random.RandomState(1)
    params = [{"w": rng.randn(5).astype(np.float32),
               "b": np.float32(rng.randn())},
              {"W1": rng.randn(3, 4).astype(np.float32),
               "b1": rng.randn(4).astype(np.float32)}]
    kw = dict(tenant="t", cid=3, seq=7, rounds=(1, 2), alphas=(0.5, 0.25),
              weak_name="logistic")
    jc = J.ChainCommit(learners=tuple(params), **kw)
    tc = T.ChainCommit(learners=tuple(params_from_numpy(params)), **kw)
    assert jc.fingerprint == tc.fingerprint
    # numpy leaves hash as the tensors do
    assert T.ChainCommit(learners=tuple(params), **kw).fingerprint == (
        tc.fingerprint)


def test_chain_mints_in_confirmation_order():
    def run(mod, _):
        chain = mod.Chain(seed=1)
        waits = [chain.submit(_commit(mod, chain.next_seq()), t=float(i))
                 for i in range(5)]
        assert all(w > 0 for w in waits)
        assert chain.height == 0
        minted = chain.advance(1e9)
        assert len(minted) == 5 and chain.height == 5
        assert chain.verify()
        times = [b.mined_at for b in chain.blocks[1:]]
        assert times == sorted(times)
        seqs = [c.seq for b in chain.blocks[1:] for c in b.commits]
        assert sorted(seqs) == list(range(1, 6))
        return waits, blocks(chain)
    j, t = both(run)
    assert j == t


def test_finalize_drains_pending_and_confirms_tip():
    def run(mod, _):
        chain = mod.Chain(seed=2, reorg_prob=0.4)
        for i in range(6):
            chain.submit(_commit(mod, chain.next_seq()), t=float(i))
        chain.advance(2.0)
        partial = chain.confirmed_hashes()
        assert chain.tail_depth == 1
        chain.finalize()
        assert chain.tail_depth == 0
        full = chain.confirmed_hashes()
        assert full[:len(partial)] == partial
        assert sum(len(b.commits) for b in chain.blocks) == 6
        assert chain.verify()
        return partial, full, chain.reorgs, blocks(chain)
    j, t = both(run)
    assert j == t


def test_verify_detects_tampered_block():
    def run(mod, _):
        chain = mod.Chain(seed=3)
        for i in range(3):
            chain.submit(_commit(mod, chain.next_seq()), t=float(i))
        chain.advance(1e9)
        assert chain.verify()
        b = chain.blocks[2]
        chain.blocks[2] = mod.Block(b.height, b.prev_hash, b.mined_at + 1.0,
                                    b.commits)
        assert not chain.verify()
        return blocks(chain)
    j, t = both(run)
    assert j == t


def test_replay_hashes_match_live_chain():
    def run(mod, _):
        chain = mod.Chain(seed=4)
        for i in range(4):
            chain.submit(_commit(mod, chain.next_seq(), cid=i), t=float(i))
        chain.advance(1e9)
        assert chain.replay_hashes() == [b.hash for b in chain.blocks[1:]]
        return chain.replay_hashes()
    j, t = both(run)
    assert j == t


@pytest.mark.parametrize("committee_size,epoch_blocks", [(2, 4), (3, 1),
                                                         (5, 2)])
def test_committee_rotates_when_leader_leaves(committee_size, epoch_blocks):
    def run(mod, _):
        chain = mod.Chain(seed=5, committee_size=committee_size,
                          epoch_blocks=epoch_blocks)
        for n in ("a", "b", "c", "d", "host-0", "scale-1"):
            chain.join(n)
        seen = [(h, chain.committee(h), chain.leader(h)) for h in range(12)]
        com = chain.committee()
        assert len(com) == min(committee_size, 6)
        leader = chain.leader()
        chain.leave(leader)
        assert chain.leader() != leader
        assert leader not in chain.committee()
        chain.submit(_commit(mod, chain.next_seq()), t=0.0)
        chain.advance(1e9)
        assert chain.replay_hashes() == [b.hash for b in chain.blocks[1:]]
        return seen, chain.participants(), blocks(chain)
    j, t = both(run)
    assert j == t


# ------------------------------------------------------------ ledger prune
def test_ledger_pruning_never_changes_waits():
    def run(beh):
        a = beh.BlockchainLedger(np.random.RandomState(0), prune_every=8)
        b = beh.BlockchainLedger(np.random.RandomState(0),
                                 prune_every=10**9)
        cur_a = [a.register() for _ in range(3)]
        cur_b = [b.register() for _ in range(3)]
        rng = np.random.RandomState(42)
        clocks = [0.0, 0.0, 0.0]
        waits = []
        for _ in range(400):
            i = rng.randint(3)
            clocks[i] += float(rng.rand())
            wa = a.commit(clocks[i], cursor=cur_a[i])
            assert wa == b.commit(clocks[i], cursor=cur_b[i])
            waits.append(wa)
        assert a.pruned_slots > 0
        assert a.live_slots < b.live_slots
        assert a.live_slots + a.pruned_slots == b.live_slots
        return waits, a.pruned_slots, a.live_slots
    assert run(jbeh) == run(tbeh)


def test_ledger_cursorless_commit_disables_pruning():
    def run(beh):
        led = beh.BlockchainLedger(np.random.RandomState(1), prune_every=4)
        cur = led.register()
        waits = [led.commit(0.0)]
        waits += [led.commit(float(i), cursor=cur) for i in range(1, 40)]
        assert led.pruned_slots == 0
        assert led.live_slots == 40
        return waits
    assert run(jbeh) == run(tbeh)


# ---------------------------------------------------------- chain registry
@pytest.mark.parametrize("args,want", [
    ((None, 0, 3), [(0, 3)]),
    (([7, 7, 2, 2, 7], 0, 5), [(0, 2), (2, 4), (4, 5)]),
    (([7, 7, 2], 2, 3), [(2, 3)]),
    (([1, 2], 2, 2), []),
    (([3, 3, 3, 1, 1, 3], 1, 6), [(1, 3), (3, 5), (5, 6)]),
])
def test_owner_runs_split(args, want):
    assert t_owner_runs(*args) == j_owner_runs(*args) == want


def test_publish_packed_folds_versions_and_provenance():
    def run(mod, _):
        reg = mod.ChainRegistry(node_id="n0", history=8)
        rows, alphas = _packed(3)
        assert reg.publish_packed("t", rows, alphas, clock=0.0,
                                  owners=[5, 5, 9], rounds=[1, 2, 1]) is None
        snap, t = None, 0.0
        while snap is None:
            t += 1.0
            reg.sync(t)
            snap = reg.latest("t")
        np.testing.assert_array_equal(np.asarray(snap.stump_params), rows)
        np.testing.assert_allclose(np.asarray(snap.alphas), alphas,
                                   rtol=1e-6)
        prov = reg.provenance("t")
        assert [(c, r) for c, r, _ in prov] == [(5, 1), (5, 2), (9, 1)]
        assert {h for _, _, h in prov} <= set(reg.chain.confirmed_hashes())
        v1 = reg.provenance("t", 1)
        assert prov[:len(v1)] == v1
        with pytest.raises(KeyError):
            reg.provenance("t", 99)
        assert reg.provenance("ghost") == ()
        return t, prov, v1, snaps(reg, "t"), blocks(reg.chain)
    j, t = both(run)
    assert j == t


def test_publish_commits_delta_only_and_refuses_shrink():
    def run(mod, _):
        reg = mod.ChainRegistry(node_id="n0")
        r1, a1 = _packed(2, seed=1)
        reg.publish_packed("t", r1, a1, clock=0.0)
        r2, a2 = _packed(5, seed=1)
        reg.publish_packed("t", r2, a2, clock=1.0)
        reg.sync(1e9)
        reg.chain.finalize()
        n = sum(c.n_entries for b in reg.chain.blocks for c in b.commits)
        assert n == 5
        with pytest.raises(ValueError, match="shrank"):
            reg.publish_packed("t", r1, a1, clock=2.0)
        with pytest.raises(ValueError, match="mismatched"):
            reg.publish("t", [{}] * 2, [1.0, 2.0, 3.0], clock=2.0)
        return snaps(reg, "t"), blocks(reg.chain)
    j, t = both(run)
    assert j == t


def test_publish_from_stump_learners_equals_publish_packed():
    """The engine's publish path: stump param dicts (tensors in the port,
    on any device) are packed and committed as the packed rows are."""
    rows, alphas = _packed(6, seed=3)
    learners = [{"feature": torch.tensor(int(r[0]), dtype=torch.int32),
                 "threshold": torch.tensor(r[1]),
                 "polarity": torch.tensor(r[2])} for r in rows]
    jreg = J.ChainRegistry(node_id="n0")
    jreg.publish_packed("t", rows, alphas, clock=0.0, owners=[0, 0, 1, 1,
                                                              1, 2],
                        rounds=[0, 1, 0, 1, 2, 0], train_progress=6)
    treg = T.ChainRegistry(node_id="n0")
    treg.publish("t", learners, list(alphas), clock=0.0,
                 owners=[0, 0, 1, 1, 1, 2], rounds=[0, 1, 0, 1, 2, 0],
                 train_progress=6)
    for reg in (jreg, treg):
        reg.chain.finalize()
    assert blocks(jreg.chain) == blocks(treg.chain)
    assert snaps(jreg, "t") == snaps(treg, "t")
    assert jreg.provenance("t") == treg.provenance("t")


def test_every_node_folds_identical_snapshots():
    def run(mod, _):
        chain = mod.Chain(seed=6)
        pub = mod.ChainRegistry(chain, node_id="pub")
        other = mod.ChainRegistry(chain, node_id="other")
        for step in range(3):
            rows, alphas = _packed(2 + 2 * step, seed=step)
            pub.publish_packed("t", rows, alphas, clock=float(step))
        chain.finalize()
        a, b = pub.latest("t"), other.latest("t")
        assert a.version == b.version and a.fingerprint == b.fingerprint
        pub.close()
        late = mod.ChainRegistry(chain, node_id="late")
        c = late.latest("t")
        assert (c.version, c.fingerprint) == (a.version, a.fingerprint)
        assert late.provenance("t") == other.provenance("t")
        assert late.digest() == other.digest()
        return (snaps(pub, "t"), snaps(other, "t"), snaps(late, "t"),
                late.provenance("t"), late.digest(), chain.participants())
    j, t = both(run)
    assert j == t


def test_generic_learner_family_round_trips():
    rng = np.random.RandomState(7)
    learners = [{"w": rng.randn(3).astype(np.float32),
                 "b": np.float32(rng.randn())} for _ in range(3)]

    def run(mod, params):
        chain = mod.Chain(seed=7)
        reg = mod.ChainRegistry(chain, node_id="n0")
        reg.publish("t", params[:2], [0.5, 0.25], clock=0.0,
                    weak_name="logistic", owners=[1, 2], rounds=[0, 0])
        reg.publish("t", params, [0.5, 0.25, 0.125], clock=1.0,
                    weak_name="logistic", owners=[1, 2, 2],
                    rounds=[0, 0, 1])
        chain.finalize()
        snap = reg.latest("t")
        assert snap.weak_name == "logistic" and snap.stump_params is None
        np.testing.assert_array_equal(np.asarray(snap.learners[0]["w"]),
                                      learners[0]["w"])
        return snaps(reg, "t"), blocks(chain), reg.provenance("t")
    j = run(J, learners)
    t = run(T, params_from_numpy(learners))
    assert j == t


# ----------------------------------------------------------- chain cluster
def test_chain_cluster_kill_any_host_and_warm_from_chain():
    def run(mod, serve):
        cl = mod.ChainCluster(3, serve.GossipConfig(seed=0))
        rows, alphas = _packed(4)
        cl.publish_packed("t", rows, alphas, clock=0.0, owners=[1, 1, 2, 2],
                          rounds=[0, 1, 0, 1])
        cl.run_until_quiescent()
        fps = {h.registry.latest("t").fingerprint for h in cl.hosts.values()}
        assert len(fps) == 1
        leader = cl.leader()
        assert leader in cl.hosts
        cl.kill(leader)
        assert cl.leader() != leader
        rows2, alphas2 = _packed(6)
        cl.publish_packed("t", rows2, alphas2, clock=1.0)
        cl.run_until_quiescent(now=1.0)
        snap = cl.latest("t")
        assert snap is not None and snap.stump_params.shape[0] == 6
        assert cl.provenance("t")
        fresh = cl.add_host("host-9", now=2.0)
        assert fresh.registry.latest("t").fingerprint == snap.fingerprint
        out = [leader, cl.leader(), cl.host_ids(), cl.provenance("t"),
               dataclasses.asdict(cl.stats), cl.digests()]
        for hid in list(cl.hosts):
            cl.remove_host(hid)
        reborn = cl.add_host("host-99", now=3.0)
        assert reborn.registry.latest("t").fingerprint == snap.fingerprint
        return out + [snaps(reborn.registry, "t"), blocks(cl.chain)]
    j, t = both(run)
    assert j == t


def test_chain_cluster_method_set_is_the_reference():
    def public(cls):
        return {n for n in dir(cls) if not n.startswith("__")}
    assert public(T.ChainCluster) == public(J.ChainCluster)
    assert public(T.ChainRegistry) == public(J.ChainRegistry)
    assert public(T.Chain) == public(J.Chain)
    assert issubclass(T.ChainCluster, TS.ShardCluster)


def test_carried_state_round_trips_and_goes_on_equal():
    """A cluster carried across keeps going as its source does: later
    commits draw the same confirmation waits and reorgs, and every node
    folds the same snapshots."""
    def build(mod, serve):
        cl = mod.ChainCluster(3, serve.GossipConfig(seed=4), reorg_prob=0.3)
        for step in range(4):
            rows, alphas = _packed(2 + 2 * step, seed=step)
            cl.publish_packed("t", rows, alphas, clock=float(step),
                              owners=[step % 2] * len(alphas))
            cl.gossip_round(float(step) + 0.5)
        cl.kill(cl.leader())
        return cl

    def go_on(cl):
        rows, alphas = _packed(12, seed=9)
        cl.publish_packed("t", rows, alphas, clock=5.0)
        cl.gossip_round(6.0)
        cl.run_until_quiescent(7.0)
        cl.add_host("late", now=8.0)
        return (blocks(cl.chain), cl.chain.reorgs, cl.leader(),
                cl.host_ids(up_only=False), cl.host_ids(),
                {h: snaps(x.registry, "t") for h, x in cl.hosts.items()},
                cl.provenance("t"), dataclasses.asdict(cl.stats))
    jcl = build(J, JS)
    state = chain_to_numpy(jcl)
    tcl = chain_from_numpy(state, TS.GossipConfig(seed=4))
    assert blocks(tcl.chain) == blocks(jcl.chain)
    assert chain_to_numpy(tcl).keys() == state.keys()
    for h in jcl.hosts:
        assert snaps(tcl.hosts[h].registry, "t") == snaps(
            jcl.hosts[h].registry, "t")
    assert go_on(tcl) == go_on(jcl)
    # a carried copy of the port's own cluster goes on as it does
    own = build(T, TS)
    copy = chain_from_numpy(chain_to_numpy(own), TS.GossipConfig(seed=4))
    assert go_on(copy) == go_on(own)
    bad = chain_to_numpy(build(T, TS))
    bad["blocks"][2]["mined_at"] += 1.0
    with pytest.raises(ValueError, match="hash"):
        chain_from_numpy(bad)


# -------------------------------------------------------------- scenario
def _small(module, name="blockchain_flchain"):
    sc = module.get_scenario(name)
    return dataclasses.replace(sc, domain=dataclasses.replace(sc.domain,
                                                              **CUT))


def _recording(monkeypatch, harness):
    """Record every response the harness's fleet hands back, in order."""
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


@pytest.fixture(scope="module")
def reference():
    sc = _small(jscen)
    cluster = J.ChainCluster(2, JS.GossipConfig(seed=0))
    data, runs = jharness.train_pair(sc, "block_delay", seed=0,
                                     n_rounds=ROUNDS, cluster=cluster)
    state = chain_to_numpy(cluster)
    mp = pytest.MonkeyPatch()
    try:
        seen = _recording(mp, jharness)
        serve = jharness.replay_serve(sc, cluster, data, "block_delay",
                                      seed=0, duration_s=DURATION)
    finally:
        mp.undo()
    return dict(data=data, runs=runs, state=state, serve=serve,
                responses=list(seen), cluster=cluster)


def test_train_pair_through_chain_cluster(reference):
    """Both packages' training publishes through a chain cluster: the
    port, handed the reference's stumps at every fit, commits the same
    blocks and folds the same snapshots and provenance."""
    jcl = reference["cluster"]
    jsnap = jcl.latest("blockchain_flchain")
    assert reference["runs"]["enhanced"].snapshots_published > 0
    prov = jcl.provenance("blockchain_flchain")
    assert len(prov) == jsnap.n_learners
    assert {c for c, _, _ in prov} <= set(range(-1, CUT["n_clients"]))
    tcl = T.ChainCluster(2, TS.GossipConfig(seed=0))
    _, runs = tharness.train_pair(_small(tscen), "block_delay", seed=0,
                                  n_rounds=ROUNDS, cluster=tcl,
                                  device="cpu")
    tcl.run_until_quiescent()
    tsnap = tcl.latest("blockchain_flchain")
    assert tsnap is not None and tsnap.version > 0
    assert len(tcl.provenance("blockchain_flchain")) == tsnap.n_learners
    counters = ("total_bytes", "n_messages", "n_syncs", "learners_merged",
                "snapshots_published", "sim_time_s")
    jm, tm = reference["runs"]["enhanced"], runs["enhanced"]
    if all(getattr(jm, c) == getattr(tm, c) for c in counters):
        # no exact tie split the runs: the chains are the same
        assert tcl.chain.height == jcl.chain.height
        assert tsnap.version == jsnap.version


def test_flchain_scenario_registered():
    for mod in (jscen, tscen):
        sc = mod.get_scenario("blockchain_flchain")
        assert sc.chain and sc.variant_of == "blockchain"
        assert set(sc.traces) >= {"legacy", "block_delay"}
        assert not mod.get_scenario("blockchain").chain


def test_replay_from_the_carried_chain_equals_reference(reference,
                                                        monkeypatch):
    sc = _small(tscen)
    cluster = chain_from_numpy(reference["state"], TS.GossipConfig(seed=0))
    data = {"test": tuple(np.asarray(a) for a in reference["data"]["test"])}
    seen = _recording(monkeypatch, tharness)
    serve = tharness.replay_serve(sc, cluster, data, "block_delay", seed=0,
                                  duration_s=DURATION, device="cpu")
    want = reference["serve"]
    assert_serve_equal(serve, want)
    assert serve["killed_host"] and serve["snapshot_version"] > 0
    assert serve["completed"] + serve["rejected"] == serve["offered"]
    ref = reference["responses"]
    assert len(seen) == len(ref) == serve["completed"]
    for a, b in zip(ref, seen):
        assert (a.rid, a.tenant, a.snapshot_version, a.t_submit) == (
            b.rid, b.tenant, b.snapshot_version, b.t_submit)
        assert abs(a.margin - b.margin) <= TOL + TOL * abs(a.margin)
    # the replay ends on the same chain, with the leader killed
    jcl = reference["cluster"]
    assert blocks(cluster.chain) == blocks(jcl.chain)
    assert cluster.chain.participants() == jcl.chain.participants()
    assert serve["killed_host"] not in cluster.chain.participants()
    assert cluster.host_ids(up_only=False) == jcl.host_ids(up_only=False)


def test_flchain_harness_kills_leader_and_serves_lossless(reference):
    """The port's own train->serve run: the leader is killed mid-replay,
    the zero-loss assertion inside the replay holds, and the report is the
    reference's (the version where no exact tie split the runs)."""
    rep = tharness.run_scenario(_small(tscen), trace="block_delay", seed=0,
                                n_rounds=ROUNDS, serve_duration_s=DURATION,
                                device="cpu")
    s, want = rep.serve, reference["serve"]
    assert s is not None and s["completed"] > 0
    assert s["killed_host"] and s["snapshot_version"] > 0
    assert_serve_equal(s, want, skip=("snapshot_version", "killed_host"))
    jm, tm = reference["runs"]["enhanced"], rep.enhanced
    counters = ("total_bytes", "n_messages", "n_syncs", "learners_merged",
                "snapshots_published", "sim_time_s")
    if all(getattr(jm, c) == getattr(tm, c) for c in counters):
        assert s["snapshot_version"] == want["snapshot_version"]
        assert s["killed_host"] == want["killed_host"]
    for c in counters:                        # baseline: learning-free
        assert (getattr(rep.baseline, c)
                == getattr(reference["runs"]["baseline"], c)), c
    assert "serve:" in tharness.summarize(rep)
