"""The port's serving stack against the JAX package's, on one snapshot.

The reference trains iot (1200 samples, 6 clients, as the serving demo
does) and publishes into its registry; its retained snapshots are carried
across with ``repro_torch.convert`` and must keep their content
fingerprints.  One request stream with 25% repeats then goes through the
reference's server and the port's ``EnsembleServer`` on the CPU, on the
stump path and on the fused fingerprint path: labels, versions, cache and
launch counters must be equal, margins within rtol/atol 1e-5, and the
fingerprint lanes of a packed batch equal bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs.paper_fedboost import FedBoostConfig  # noqa: E402
from repro.core import FederatedBoostEngine  # noqa: E402
from repro.data import make_domain_data  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.dispatch import KernelPolicy as JaxPolicy  # noqa: E402
from repro.serve import (BatchConfig as JaxBatchConfig,  # noqa: E402
                         EnsembleRegistry as JaxRegistry,
                         EnsembleServer as JaxServer)
from repro.sim.scenarios import DOMAINS  # noqa: E402
from repro_torch.convert import (params_from_numpy,  # noqa: E402
                                 snapshot_from_numpy, stumps_from_numpy)
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels.ops import KernelPolicy  # noqa: E402
from repro_torch.serve import (BatchConfig, EnsembleRegistry,  # noqa: E402
                               EnsembleServer)

TENANT = "iot"


def SERVICE(n_kernel):
    """Simulated batch service time, so both servers batch identically."""
    return 1e-3 + 1e-4 * n_kernel


@pytest.fixture(scope="module")
def trained():
    registry = JaxRegistry()
    dom = dataclasses.replace(DOMAINS["iot"], n_samples=1200, n_clients=6)
    data = make_domain_data(dom, seed=0)
    cfg = FedBoostConfig(n_clients=6, n_rounds=10, seed=0,
                         balanced_init=True)
    engine = FederatedBoostEngine(cfg, data, "enhanced")
    engine.attach_registry(registry, TENANT)
    engine.run()
    port = EnsembleRegistry()
    for snap in registry.history(TENANT):
        assert port.ingest(snapshot_from_numpy(
            np.asarray(snap.stump_params), np.asarray(snap.alphas),
            tenant=snap.tenant, version=snap.version,
            train_progress=snap.train_progress,
            published_at=snap.published_at))
    registry.rebase_clock(0.0)
    port.rebase_clock(0.0)
    xt = np.asarray(data["test"][0], np.float32)
    rng = np.random.RandomState(3)
    rows = []
    for i in range(400):
        if rows and rng.rand() < 0.25:
            rows.append(rows[rng.randint(len(rows))])     # a repeat
        else:
            rows.append(i % len(xt))
    return registry, port, xt, rows


def test_carried_snapshots_keep_their_fingerprints(trained):
    registry, port, _, _ = trained
    for snap in registry.history(TENANT):
        got = port.get(TENANT, snap.version)
        assert got is not None and got.n_learners == snap.n_learners
        assert got.fingerprint == snap.fingerprint
    assert port.latest(TENANT).version == registry.latest(TENANT).version


def test_publishing_carried_learners_gives_the_same_fingerprint(trained):
    registry, _, _, _ = trained
    snap = registry.latest(TENANT)
    sp = np.asarray(snap.stump_params)
    learners = stumps_from_numpy(sp[:, 0].astype(np.int64), sp[:, 1],
                                 sp[:, 2])
    mine = EnsembleRegistry().publish(
        TENANT, learners, [float(a) for a in np.asarray(snap.alphas)],
        clock=snap.published_at, train_progress=snap.train_progress)
    assert mine.fingerprint == snap.fingerprint
    # generic learners: each dict's leaves hashed in sorted key order, the
    # 0-d biases included, as the reference walks its pytree
    rng = np.random.RandomState(1)
    mlps = [{"w1": rng.randn(5, 16).astype(np.float32),
             "b1": rng.randn(16).astype(np.float32),
             "w2": rng.randn(16).astype(np.float32),
             "b2": np.float32(rng.randn())} for _ in range(3)]
    alphas = [0.5, 0.25, 0.125]
    want = JaxRegistry().publish(
        TENANT, [{k: jnp.asarray(v) for k, v in p.items()} for p in mlps],
        alphas, clock=2.0, train_progress=3, weak_name="mlp")
    got = EnsembleRegistry().publish(
        TENANT, params_from_numpy(mlps), alphas, clock=2.0,
        train_progress=3, weak_name="mlp")
    assert got.weak_name == "mlp" and got.n_learners == 3
    assert got.fingerprint == want.fingerprint


def _serve(server, xt, rows):
    hits = [0]
    evaluate = server.evaluator.evaluate

    def counting(batch):
        out = evaluate(batch)
        hits[0] += server.evaluator.last_eval.fp_hits
        return out
    server.evaluator.evaluate = counting
    responses = []
    for i, row in enumerate(rows):
        accepted, done = server.submit(TENANT, xt[row], now=i * 5e-4)
        assert accepted
        responses += done
    responses += server.drain()
    return sorted(responses, key=lambda r: r.rid), hits[0]


@pytest.mark.parametrize("path,cache", [("stump", 0), ("stump", 256),
                                        ("fused", 256)])
def test_stream_matches_reference(trained, path, cache):
    registry, port, xt, rows = trained
    fused = path == "fused"
    ref_server = JaxServer(
        registry, JaxBatchConfig(max_batch=16, cache_capacity=cache),
        service_model=SERVICE,
        policy=JaxPolicy(backend="xla", fused_fingerprint=fused))
    server = EnsembleServer(
        port, BatchConfig(max_batch=16, cache_capacity=cache),
        service_model=SERVICE, policy=KernelPolicy(fused_fingerprint=fused),
        device="cpu")
    want, want_hits = _serve(ref_server, xt, rows)
    got, got_hits = _serve(server, xt, rows)
    ref_server.close()
    server.close()
    assert [r.rid for r in got] == [r.rid for r in want]
    assert [r.label for r in got] == [r.label for r in want]
    assert ([r.snapshot_version for r in got]
            == [r.snapshot_version for r in want])
    np.testing.assert_allclose([r.margin for r in got],
                               [r.margin for r in want], rtol=1e-5, atol=1e-5)
    ev, jev = server.evaluator, ref_server.evaluator
    assert ev.kernel_launches == jev.kernel_launches > 0
    assert ev.host_hash_calls == jev.host_hash_calls
    assert got_hits == want_hits
    if cache:
        a, b = server.cache.stats, ref_server.cache.stats
        assert (a.hits, a.misses, a.fills) == (b.hits, b.misses, b.fills)
    if fused:
        assert got_hits > 0 and ev.host_hash_calls == 0
    rep, jrep = server.metrics.report(), ref_server.metrics.report()
    for k in ("completed", "n_batches", "p50_ms", "p99_ms", "mean_batch"):
        assert rep[k] == pytest.approx(jrep[k], rel=1e-9), k


def test_packed_batch_lanes_bit_equal(trained):
    registry, port, xt, rows = trained
    from repro.serve.batching import Request as JaxRequest
    from repro.serve.engine import BatchEvaluator as JaxEvaluator
    from repro_torch.serve.batching import Request
    from repro_torch.serve.engine import BatchEvaluator
    reqs = [Request(i, TENANT, xt[r], 0.0) for i, r in enumerate(rows[:48])]
    jreqs = [JaxRequest(i, TENANT, jnp.asarray(xt[r]), 0.0)
             for i, r in enumerate(rows[:48])]
    block = BatchEvaluator(port, device="cpu")._pack_stumps(
        [(port.latest(TENANT), reqs)])
    jblock = JaxEvaluator(registry)._pack_stumps(
        [(registry.latest(TENANT), jreqs)])
    for a, b in zip(block, jblock):
        np.testing.assert_array_equal(a.numpy(), b)
    _, f0, f1 = ref.stump_vote_fp_batched_ref(*block)
    _, j0, j1 = jref.stump_vote_fp_batched_ref(*map(jnp.asarray, jblock))
    np.testing.assert_array_equal(f0.numpy().view(np.uint32), np.asarray(j0))
    np.testing.assert_array_equal(f1.numpy().view(np.uint32), np.asarray(j1))


def test_unported_serving_paths_raise():
    """The per-(tenant, host) policy table is ported: both servers take
    one, and refuse it beside the per-tenant ``policy_for=`` it replaces.
    The sharded fleet serves under the table, and without a card the
    default device raises."""
    from repro_torch.serve import (GossipConfig, PolicyTable, ShardCluster,
                                   ShardedEnsembleServer)
    table = PolicyTable(BatchConfig(max_batch=4))
    with pytest.raises(ValueError, match="policy_for"):
        EnsembleServer(EnsembleRegistry(), policy_table=table,
                       policy_for=lambda t: None, device="cpu")
    assert EnsembleServer(EnsembleRegistry(), policy_table=table,
                          device="cpu").cfg.max_batch == 4
    cluster = ShardCluster(2, GossipConfig(seed=0))
    rng = np.random.RandomState(0)
    p = np.zeros((3, 4), np.float32)
    p[:, 1] = rng.randn(3)
    p[:, 2] = 1.0
    cluster.publish_packed(TENANT, p, np.ones(3, np.float32))
    cluster.run_until_quiescent()
    server = ShardedEnsembleServer(cluster, BatchConfig(),
                                   service_model=SERVICE, device="cpu",
                                   policy_table=table)
    # the explicit cfg is the fleet default the table's layers stack onto
    assert all(s.policy_table is not None and s.cfg.max_batch == 64
               for s in server.servers.values())
    ok, out = server.submit(TENANT, rng.randn(4).astype(np.float32), 0.0)
    out += server.drain()
    assert ok and len(out) == 1 and out[0].snapshot_version == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ShardedEnsembleServer(cluster)
