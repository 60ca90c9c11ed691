"""Per-(tenant, host) serving policies in the port against the JAX
package's: PolicyTable resolution and JSON (one file loads in both, with
equal batch fields and pins in the same roles), per-tenant admission and
batch caps (one submit sequence through both packages' queues admits the
same requests and batches the same rids), value-equal kernel policies
sharing one launch, per-tenant kernel policies partitioning launches, and
an explicit config composing with a table."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.dispatch import KernelPolicy as JaxPolicy  # noqa: E402
from repro.serve import (BatchConfig as JaxBatchConfig,  # noqa: E402
                         EnsembleRegistry as JaxRegistry,
                         EnsembleServer as JaxServer,
                         MicroBatchQueue as JaxQueue,
                         PolicyTable as JaxTable)
from repro_torch.kernels.dispatch import ENV_VAR, KernelPolicy  # noqa: E402
from repro_torch.serve import (BatchConfig, EnsembleRegistry,  # noqa: E402
                               EnsembleServer, GossipConfig, MicroBatchQueue,
                               PolicyTable, ShardCluster,
                               ShardedEnsembleServer)

# the reference's backend names and the port's backend in the same role
ROLE = {"xla": "torch", "mosaic": "cuda", None: None}


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    monkeypatch.delenv(ENV_VAR, raising=False)


def _params(T=4, F=6, seed=0):
    rng = np.random.RandomState(seed)
    p = np.zeros((T, 4), np.float32)
    p[:, 0] = rng.randint(0, F, size=T)
    p[:, 1] = rng.randn(T)
    p[:, 2] = np.where(rng.rand(T) > 0.5, 1.0, -1.0)
    a = (rng.rand(T) + 0.1).astype(np.float32)
    return p, a


def _publish(target, tenant, T=4, F=6, seed=0, clock=0.0):
    p, a = _params(T, F, seed)
    return target.publish_packed(tenant, p, a, clock=clock)


def _cluster(n_hosts, tenants, seed=0):
    cluster = ShardCluster(n_hosts, GossipConfig(seed=seed))
    for i, t in enumerate(tenants):
        _publish(cluster, t, seed=i)
    cluster.run_until_quiescent()
    return cluster


TENANTS = [f"t{i}" for i in range(6)]


def _fields(cfg):
    return dataclasses.asdict(cfg)


# ------------------------------------------------------------ policy table
def test_policy_table_resolution_precedence():
    pt = PolicyTable(BatchConfig(max_batch=16, queue_budget=100))
    jt = JaxTable(JaxBatchConfig(max_batch=16, queue_budget=100))
    for table in (pt, jt):
        table.set_host("h0", max_batch=32)
        table.set_tenant("hot", queue_budget=400, max_batch=64)
        table.set_pair("hot", "h0", max_batch=8)
    assert pt.batch_for().max_batch == 16               # fleet default
    assert pt.batch_for(host="h0").max_batch == 32      # host layer
    assert pt.batch_for("hot", "h1").max_batch == 64    # tenant over host
    assert pt.batch_for("hot", "h1").queue_budget == 400
    assert pt.batch_for("hot", "h0").max_batch == 8     # pair most specific
    assert pt.batch_for("hot", "h0").queue_budget == 400  # merged field-wise
    assert pt.batch_for("cold", "h9") is pt.batch_for()  # untouched scopes
    for scope in ((None, None), (None, "h0"), ("hot", "h1"), ("hot", "h0"),
                  ("cold", "h9")):
        assert _fields(pt.batch_for(*scope)) == _fields(jt.batch_for(*scope))
    for table in (pt, jt):
        with pytest.raises(ValueError):
            table.set_tenant("x", no_such_field=1)
        with pytest.raises(ValueError):
            table.set_host("h0", scheduler=None)        # fleet-wide only
        with pytest.raises(ValueError):
            table.set_tenant("x", fixed_window_units=1)
        with pytest.raises(ValueError):
            table.set_pair("x", "h0", cache_capacity=64)
        table.set_host("h0", fixed_window_units=1)      # host scope: fine


def test_policy_table_kernel_resolution():
    plain, card = KernelPolicy(backend="torch"), KernelPolicy(backend="cuda")
    pt = PolicyTable()
    assert pt.kernel_for("a", "h0") is None             # caller's policy
    pt.set_host("h0", kernel=card)
    pt.set_tenant("a", kernel=plain)
    assert pt.kernel_for("a", "h0") is plain            # tenant over host
    assert pt.kernel_for("b", "h0") is card
    assert pt.kernel_for("b", "h1") is None


def test_policy_table_json_roundtrip(tmp_path):
    path = tmp_path / "policies.json"
    pt = PolicyTable(BatchConfig(max_batch=32),
                     default_kernel=KernelPolicy(backend="torch"))
    pt.set_tenant("hot", queue_budget=1024,
                  kernel=KernelPolicy(backend="cuda"))
    pt.set_host("h1", cache_capacity=128)
    pt.set_pair("hot", "h1", max_batch=4,
                kernel=KernelPolicy(fused_fingerprint=True))
    pt.save(path)
    back = PolicyTable.load(path)
    assert back.batch_for().max_batch == 32
    assert back.default_kernel.backend == "torch"
    assert back.batch_for("hot", "h0").queue_budget == 1024
    assert back.batch_for(host="h1").cache_capacity == 128
    assert back.batch_for("hot", "h1").max_batch == 4
    assert back.kernel_for("hot", "h9").backend == "cuda"
    assert back.kernel_for("hot", "h1").fused_fingerprint
    with pytest.raises(ValueError):
        bad = dict(json.loads(path.read_text()), pairs={"nohost": {}})
        path.write_text(json.dumps(bad))
        PolicyTable.load(path)
    # an empty kernel spec would mask broader pins as "most specific"
    path.write_text(json.dumps({"tenants": {"a": {"kernel": {}}}}))
    with pytest.raises(ValueError):
        PolicyTable.load(path)
    path.write_text(json.dumps({"tenants": {"a": {"kernel": {
        "backend": "interpret"}}}}))
    with pytest.raises(KeyError, match="unknown kernel backend"):
        PolicyTable.load(path)


def test_one_json_table_loads_in_both_packages(tmp_path):
    """The JAX package's table format: equal batch fields at every scope
    and each kernel pin in the same role (``xla`` the oracle, ``mosaic``
    the kernel), a calibration table included."""
    jcal = JaxPolicy()
    jcal.record("stump_vote_batched", (1, 512, 128), "xla")
    cal = jcal.save(str(tmp_path / "cal.json"), measured_on="cpu")
    doc = {"default": {"max_batch": 48, "queue_budget": 600},
           "default_kernel": {"backend": "mosaic"},
           "hosts": {"host-0": {"batch": {"queue_budget": 700,
                                          "fixed_window_units": 3}},
                     "host-2": {"kernel": {"backend": "xla"}}},
           "tenants": {"iot": {"batch": {"queue_budget": 64,
                                         "max_batch": 8},
                               "kernel": {"fused_fingerprint": True}},
                       "edge_vision": {"kernel": {"calibration": cal}}},
           "pairs": {"edge_vision@host-0": {"batch": {"max_batch": 16}},
                     "iot@host-2": {"kernel": {"backend": "mosaic",
                                               "fused_fingerprint": True}}}}
    path = tmp_path / "table.json"
    path.write_text(json.dumps(doc))
    pt, jt = PolicyTable.load(path), JaxTable.load(path)
    for tenant in (None, "iot", "edge_vision", "mobile"):
        for host in (None, "host-0", "host-1", "host-2"):
            assert _fields(pt.batch_for(tenant, host)) == \
                _fields(jt.batch_for(tenant, host)), (tenant, host)
            k, jk = pt.kernel_for(tenant, host), jt.kernel_for(tenant, host)
            assert (k is None) == (jk is None)
            assert k.backend == ROLE[jk.backend], (tenant, host)
            assert k.fused_fingerprint == jk.fused_fingerprint
            assert {key: ROLE[e.backend] for key, e in jk.table.items()} == \
                {key: e.backend for key, e in k.table.items()}
    # a save loads back to equal fields (a calibration table is not
    # serialized, in either package)
    with pytest.warns(RuntimeWarning, match="calibration table"):
        pt.save(tmp_path / "port.json")
    again = PolicyTable.load(tmp_path / "port.json")
    assert _fields(again.batch_for("iot", "host-0")) == \
        _fields(jt.batch_for("iot", "host-0"))


def test_per_tenant_queue_budget_and_batch_cap():
    reg = EnsembleRegistry()
    _publish(reg, "hot", seed=1)
    _publish(reg, "cold", seed=2)
    pt = PolicyTable(BatchConfig(queue_budget=8, max_batch=16,
                                 adaptive=False, fixed_window_units=1000))
    pt.set_tenant("cold", queue_budget=2, max_batch=1)
    server = EnsembleServer(reg, policy_table=pt, host_id="h0",
                            service_model=lambda n: 1e-4, device="cpu")
    assert server.submit("cold", np.zeros(6, np.float32), 0.0)[0]
    assert server.submit("cold", np.zeros(6, np.float32), 0.0)[0]
    assert not server.submit("cold", np.zeros(6, np.float32), 0.0)[0]
    assert server.metrics.tenants["cold"].rejected == 1
    for _ in range(6):
        assert server.submit("hot", np.zeros(6, np.float32), 0.0)[0]
    assert not server.submit("hot", np.zeros(6, np.float32), 0.0)[0]
    assert server.queue.tenant_depth("hot") == 6
    batch = server.queue.pop_batch()
    assert len(batch) == 7
    assert sum(r.tenant == "cold" for r in batch) == 1
    assert sum(r.tenant == "hot" for r in batch) == 6
    assert [r.tenant for r in server.queue.pop_batch()] == ["cold"]
    assert server.queue.tenant_depth("cold") == 0


def test_per_tenant_batch_cap_preserves_fifo_of_overflow():
    cfg = BatchConfig(queue_budget=64, max_batch=4)
    capped = BatchConfig(queue_budget=64, max_batch=1)
    q = MicroBatchQueue(cfg, tenant_cfg=lambda t: capped if t == "c" else cfg)
    for i, t in enumerate("ccab"):
        q.submit(t, [float(i)], float(i))
    first = q.pop_batch()
    assert [r.tenant for r in first] == ["c", "a", "b"]  # 2nd c deferred
    assert [r.tenant for r in q.pop_batch()] == ["c"]    # kept FIFO slot
    assert q.depth == 0


def test_hot_tenant_raises_above_host_scope_take_effect():
    pt = PolicyTable(BatchConfig(queue_budget=4, max_batch=2))
    pt.set_tenant("hot", queue_budget=10, max_batch=8)
    q = MicroBatchQueue(pt.batch_for(host="h0"),
                        tenant_cfg=lambda t: pt.batch_for(t, "h0"))
    for _ in range(2):
        assert q.submit("cold", [0.0], 0.0) is not None
    for _ in range(8):
        assert q.submit("hot", [0.0], 0.0) is not None
    assert q.submit("hot", [0.0], 0.0) is None
    assert q.submit("cold", [0.0], 0.0) is None
    assert q.rejected == 2
    batch = q.pop_batch()
    assert len(batch) == 8
    assert sum(r.tenant == "hot" for r in batch) == 6
    assert sum(r.tenant == "cold" for r in batch) == 2
    assert [r.tenant for r in q.pop_batch()] == ["hot", "hot"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_queue_admissions_and_batches_equal_the_references(seed):
    """One random submit/pop/requeue sequence through both packages'
    per-tenant queues: the same admissions, the same rids in every batch,
    the same per-tenant depths and rejection count."""
    rng = np.random.RandomState(seed)
    doc = {"default": {"queue_budget": 12, "max_batch": 5},
           "tenants": {"hot": {"batch": {"queue_budget": 20,
                                         "max_batch": 9}},
                       "cold": {"batch": {"queue_budget": 3,
                                          "max_batch": 1}},
                       "mid": {"batch": {"max_batch": 2}}},
           "pairs": {"mid@h0": {"batch": {"queue_budget": 4}}}}
    pt = PolicyTable(BatchConfig(**doc["default"]))
    jt = JaxTable(JaxBatchConfig(**doc["default"]))
    for table in (pt, jt):
        for t, spec in doc["tenants"].items():
            table.set_tenant(t, **spec["batch"])
        table.set_pair("mid", "h0", **doc["pairs"]["mid@h0"]["batch"])
    q = MicroBatchQueue(pt.batch_for(host="h0"),
                        tenant_cfg=lambda t: pt.batch_for(t, "h0"))
    jq = JaxQueue(jt.batch_for(host="h0"),
                  tenant_cfg=lambda t: jt.batch_for(t, "h0"))
    tenants = ["hot", "hot", "hot", "cold", "mid", "other"]
    for step in range(400):
        r = rng.rand()
        if r < 0.85:
            t = tenants[rng.randint(len(tenants))]
            x = rng.randn(3).astype(np.float32)
            a, b = q.submit(t, x, float(step)), jq.submit(t, x, float(step))
            assert (a is None) == (b is None), step
            if a is not None:
                assert a.rid == b.rid and a.tenant == b.tenant
        elif r < 0.98:
            got, want = q.pop_batch(), jq.pop_batch()
            assert [(g.rid, g.tenant) for g in got] == \
                [(w.rid, w.tenant) for w in want], step
            if got and rng.rand() < 0.3:       # a reroute re-admits one
                q.requeue(got[0])
                jq.requeue(want[0])
        else:
            assert [g.rid for g in q.pop_all()] == \
                [w.rid for w in jq.pop_all()]
        for t in set(tenants):
            assert q.tenant_depth(t) == jq.tenant_depth(t)
        assert q.depth == jq.depth
    assert q.rejected == jq.rejected > 0


def test_cluster_policy_table_reaches_added_hosts():
    """Scaled-out hosts inherit the table: a host added later resolves its
    own host and pair layers from it."""
    cluster = _cluster(2, TENANTS[:2])
    pt = PolicyTable(BatchConfig(max_batch=12))
    pt.set_host("h-new", queue_budget=77)
    pt.set_pair("t0", "h-new", max_batch=3)
    server = ShardedEnsembleServer(cluster, policy_table=pt,
                                   service_model=lambda n: 1e-4,
                                   device="cpu")
    new = server.add_host("h-new")
    assert new.policy_table is pt and new.cfg.queue_budget == 77
    assert new.queue._cfg_for("t0").max_batch == 3
    assert all(s.cfg.max_batch == 12 for s in server.servers.values())


def test_value_equal_kernel_policies_share_one_launch(monkeypatch):
    from repro_torch.serve import engine as engine_mod
    reg = EnsembleRegistry()
    for i, t in enumerate("abc"):
        _publish(reg, t, seed=i)
    pt = PolicyTable()
    for t in "abc":                               # three distinct objects
        pt.set_tenant(t, kernel=KernelPolicy(backend="torch"))
    calls = []
    real = engine_mod.kops.stump_vote_batched
    monkeypatch.setattr(engine_mod.kops, "stump_vote_batched",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    server = EnsembleServer(reg, policy_table=pt, host_id="h",
                            service_model=lambda n: 1e-4, device="cpu")
    for t in "abc":
        server.submit(t, np.zeros(6, np.float32), 0.0)
    assert len(server.drain()) == 3
    assert len(calls) == 1                        # one packed (B,T,N) launch


def test_per_tenant_kernel_policy_partitions_launches():
    """Two tenants pinned apart: two launches, each through its own
    policy's dispatcher (on the CPU the cuda pin warns and runs the plain
    version), both tenants served the reference's margins."""
    reg, jreg = EnsembleRegistry(), JaxRegistry()
    for i, t in enumerate("ab"):
        _publish(reg, t, seed=i)
        p, a = _params(seed=i)
        jreg.publish_packed(t, jnp.asarray(p), jnp.asarray(a), clock=0.0)
    plain, card = KernelPolicy(backend="torch"), KernelPolicy(backend="cuda")
    pt = PolicyTable(BatchConfig(max_batch=16))
    pt.set_tenant("a", kernel=plain)
    pt.set_tenant("b", kernel=card)
    jt = JaxTable(JaxBatchConfig(max_batch=16))
    jt.set_tenant("a", kernel=JaxPolicy(backend="xla"))
    jt.set_tenant("b", kernel=JaxPolicy(backend="xla"))
    server = EnsembleServer(reg, policy_table=pt, host_id="h",
                            service_model=lambda n: 1e-4, device="cpu")
    jserver = JaxServer(jreg, policy_table=jt, host_id="h",
                        service_model=lambda n: 1e-4)
    rng = np.random.RandomState(0)
    xs = {t: rng.randn(6).astype(np.float32) for t in "ab"}
    for t in "ab":
        server.submit(t, xs[t], 0.0)
        jserver.submit(t, xs[t], 0.0)
    with pytest.warns(RuntimeWarning, match="unavailable"):
        responses = server.drain()
    jresponses = jserver.drain()
    assert len(responses) == 2
    assert server.evaluator.kernel_launches == 2
    assert set(plain.choices.values()) == {"torch"}
    assert set(card.choices.values()) == {"torch"}   # cuda fell through
    for r, jr in zip(responses, jresponses):
        assert (r.rid, r.tenant, r.snapshot_version) == \
            (jr.rid, jr.tenant, jr.snapshot_version)
        assert r.margin == pytest.approx(jr.margin, rel=1e-5, abs=1e-5)


def test_explicit_cfg_composes_with_policy_table():
    cluster = _cluster(2, TENANTS[:2])
    pt = PolicyTable(BatchConfig(queue_budget=999))
    pt.set_tenant("t0", max_batch=4)
    explicit = BatchConfig(queue_budget=5, adaptive=False,
                           fixed_window_units=7)
    server = ShardedEnsembleServer(cluster, explicit, policy_table=pt,
                                   service_model=lambda n: 1e-4,
                                   device="cpu")
    for s in server.servers.values():
        assert s.cfg.queue_budget == 5          # explicit beats table default
        assert s.cfg.fixed_window_units == 7
    hid = next(iter(server.servers))
    resolved = server.servers[hid].policy_table.batch_for("t0", hid)
    assert resolved.max_batch == 4              # tenant override still layers
    assert resolved.queue_budget == 5
