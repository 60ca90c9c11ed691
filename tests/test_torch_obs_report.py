"""The port's trace reporter (``repro_torch.launch.obs_report``) against
the JAX package's, on the CPU.

Both reporters read the same span lists: traces the port writes (a
sharded fleet's requests, a chain commit folded on other nodes) and the
JAX package's own chain trace.  Self times, aggregates, the per-phase
breakdown, folded stacks, the stitched cross-node tree, the validation
verdicts of the JAX package's ``tests/test_trace_propagation.py`` cases
and the kernel profile of a hand-built metrics snapshot must be equal,
and so must the CLI's output on one exported trace.  ``write_trace``
round-trips through ``load_trace``.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.chain as JC  # noqa: E402
import repro.launch.obs_report as J  # noqa: E402
import repro.obs as jobs  # noqa: E402
import repro_torch.chain as TC  # noqa: E402
import repro_torch.launch.obs_report as T  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro_torch.serve import (BatchConfig, GossipConfig,  # noqa: E402
                               ShardCluster, ShardedEnsembleServer)
from repro_torch.sim import traces as ttraces  # noqa: E402

TOL = 1e-6


def _packed(n, seed=0, F=6):
    rng = np.random.RandomState(seed)
    rows = np.zeros((n, 4), np.float32)
    rows[:, 0] = rng.randint(0, F, size=n)
    rows[:, 1] = rng.randn(n)
    rows[:, 2] = np.where(rng.rand(n) > 0.5, 1.0, -1.0)
    return rows, (rng.rand(n) + 0.1).astype(np.float32)


def _fleet_spans(n_requests=40, seed=0):
    """The port's traced sharded fleet (the JAX package's
    ``_traced_fleet_run``): four tenants on three hosts, Poisson traffic."""
    tenants = [f"tenant-{i}" for i in range(4)]
    with tobs.tracing() as tracer:
        cluster = ShardCluster(3, GossipConfig(seed=seed))
        for i, t in enumerate(tenants):
            rows, alphas = _packed(6, seed=i, F=8)
            cluster.publish_packed(t, rows, alphas)
        cluster.run_until_quiescent()
        server = ShardedEnsembleServer(
            cluster, BatchConfig(queue_budget=64, max_batch=8),
            service_model=lambda n: 1e-3 + 1e-4 * n, device="cpu")
        rng = np.random.RandomState(seed)
        t = 0.0
        for _ in range(n_requests):
            t += rng.exponential(1.0 / 300.0)
            server.submit(tenants[rng.randint(len(tenants))],
                          rng.randn(8).astype(np.float32), t)
        server.drain()
        return tracer.finished(), tracer.meta()


def _chain_spans(mod, obs):
    chain = mod.Chain(seed=3)
    pub = mod.ChainRegistry(chain, node_id="pub")
    others = [mod.ChainRegistry(chain, node_id=f"node-{i}")
              for i in range(2)]
    with obs.tracing() as tracer:
        for step in range(3):
            rows, alphas = _packed(2 + step, seed=step)
            pub.publish_packed("t", rows, alphas, clock=float(step))
        chain.finalize()
        for o in others:
            o.latest("t")                   # folds the confirmed blocks
        return tracer.finished(), [b.hash for b in chain.blocks]


@pytest.fixture(scope="module")
def span_lists():
    fleet, meta = _fleet_spans()
    port_chain, _ = _chain_spans(TC, tobs)
    ref_chain, _ = _chain_spans(JC, jobs)
    return {"fleet": fleet, "port_chain": port_chain,
            "ref_chain": ref_chain, "meta": meta}


LISTS = ("fleet", "port_chain", "ref_chain")


@pytest.mark.parametrize("which", LISTS)
def test_analysis_equals_reference(span_lists, which):
    spans = span_lists[which]
    assert spans
    assert T.self_times(spans) == J.self_times(spans)
    assert T.aggregate(spans) == J.aggregate(spans)
    assert T.phase_breakdown(spans) == J.phase_breakdown(spans)
    assert T.folded_stacks(spans) == J.folded_stacks(spans)
    for meta in (None, {"dropped": 0}, {"dropped": 3}):
        assert T.check_trace(spans, meta) == J.check_trace(spans, meta)
    assert T.check_trace(spans, {"dropped": 0}) == []
    for key in ("auto", "rid:3", "rid:999", "no-such-trace"):
        assert (T.resolve_trace_key(spans, key)
                == J.resolve_trace_key(spans, key))


def test_port_fleet_trace_checks_and_stitches(span_lists):
    """The port's sharded fleet trace passes the check, and the slowest
    request's stitched trace reconstructs its end-to-end latency."""
    spans = span_lists["fleet"]
    assert T.check_trace(spans, span_lists["meta"]) == []
    tid = T.resolve_trace_key(spans, "auto")
    st = T.stitch_trace(spans, tid)
    assert st == J.stitch_trace(spans, tid)
    assert st["hosts"]
    names = {s["name"] for s in st["members"]}
    assert {"serve.submit", "serve.request"} <= names
    req = next(s for s in st["members"] if s["name"] == "serve.request")
    assert st["e2e_s"] == pytest.approx(req["attrs"]["latency_s"], abs=TOL)
    assert st["parts_s"] == pytest.approx(st["e2e_s"], abs=TOL)
    assert T.resolve_trace_key(spans, f"rid:{req['attrs']['rid']}") == tid


# --------------------------------------------------------- check_trace rules
def _span(name, span, trace, parent=None, links=(), t0=0.0, t1=1.0):
    d = {"name": name, "span": span, "parent": parent, "trace": trace,
         "host": "", "t0": t0, "t1": t1, "sim_t0": None, "sim_t1": None,
         "attrs": {}}
    if links:
        d["links"] = [list(lk) for lk in links]
    return d


def _request(span, latency, parts, sim=None):
    d = _span("serve.request", span, "tR")
    d["attrs"] = dict(latency_s=latency, queue_s=parts[0], batch_s=parts[1],
                      kernel_s=parts[2])
    if sim is not None:
        d["sim_t0"], d["sim_t1"] = sim
    return d


CHECK_CASES = {
    "cross_trace_child_without_link": (
        [_span("batch", 1, "tA"),
         _span("req", 2, "tB", parent=1, t0=0.1, t1=0.9)],
        "no link into its own trace"),
    "cross_trace_child_linked_dropped_target": (
        [_span("batch", 1, "tA"),
         _span("req", 2, "tB", parent=1, links=[("tB", 99)], t0=0.1,
               t1=0.9)], "links to missing span"),
    "link_trace_mismatch": (
        [_span("origin", 1, "tA"),
         _span("cont", 2, "tB", links=[("tB", 1)], t0=2.0, t1=3.0)],
        "link claims span 1 is in trace tB"),
    "missing_parent": ([_span("child", 2, "tA", parent=1)],
                       "missing parent"),
    "escapes_parent": (
        [_span("p", 1, "tA", t0=0.0, t1=1.0),
         _span("c", 2, "tA", parent=1, t0=0.5, t1=2.0)], "escapes parent"),
    "never_ended": ([dict(_span("open", 1, "tA"), t1=None)], "never ended"),
    "ends_before_start": ([_span("back", 1, "tA", t0=2.0, t1=1.0)],
                          "ends before it starts"),
    "duplicate_id": ([_span("a", 1, "tA"), _span("b", 1, "tA")],
                     "duplicate span id"),
    "request_decomposition": (
        [_request(1, 0.010, (0.001, 0.002, 0.003), sim=(0.0, 0.010))],
        "queue+batch+kernel"),
    "request_sim_interval": (
        [_request(1, 0.006, (0.001, 0.002, 0.003), sim=(0.0, 0.010))],
        "sim interval != latency"),
    "clean_request": (
        [_request(1, 0.006, (0.001, 0.002, 0.003), sim=(0.0, 0.006))], None),
}


@pytest.mark.parametrize("case", sorted(CHECK_CASES))
@pytest.mark.parametrize("meta", [None, {"dropped": 0}, {"dropped": 5}],
                         ids=["headerless", "complete", "dropped"])
def test_check_trace_cases_equal_reference(case, meta):
    spans, needle = CHECK_CASES[case]
    errs = T.check_trace(spans, meta)
    assert errs == J.check_trace(spans, meta)
    tolerated = needle in ("missing parent", "links to missing span")
    if needle is None or (tolerated and meta == {"dropped": 5}):
        assert errs == []
    else:
        assert any(needle in e for e in errs), errs


# -------------------------------------------------------- chain stitching
def test_chain_commit_trace_links_through_mint_and_fold(span_lists):
    spans = span_lists["port_chain"]
    commits = [s for s in spans if s["name"] == "chain.commit"]
    mints = [s for s in spans if s["name"] == "chain.mint"]
    aggs = [s for s in spans if s["name"] == "chain.aggregate"]
    assert commits and mints and aggs
    commit_edges = {(c["trace"], c["span"]) for c in commits}
    assert all(c["host"] == "pub" for c in commits)
    mint_links = {tuple(lk) for m in mints for lk in m.get("links", [])}
    assert commit_edges <= mint_links
    for node in ("node-0", "node-1"):
        agg = next(a for a in aggs if a["host"] == node and a.get("links"))
        assert commit_edges <= {tuple(lk) for lk in agg["links"]}
    assert T.check_trace(spans, {"dropped": 0}) == []
    st = T.stitch_trace(spans, commits[0]["trace"])
    assert st == J.stitch_trace(spans, commits[0]["trace"])
    names = {s["name"] for s in st["members"]}
    assert {"chain.commit", "chain.mint", "chain.aggregate"} <= names
    folded_on = {s["host"] for s in st["members"]
                 if s["name"] == "chain.aggregate"}
    assert {"node-0", "node-1"} <= folded_on
    # the same run in the JAX package gives the same span shapes
    ref = span_lists["ref_chain"]
    assert ([(s["name"], s["host"], s["attrs"]) for s in ref]
            == [(s["name"], s["host"], s["attrs"]) for s in spans])


def test_chain_hashes_unaffected_by_tracing():
    rows, alphas = _packed(4, seed=1)

    def run(traced):
        chain = TC.Chain(seed=9)
        reg = TC.ChainRegistry(chain, node_id="n0")
        if traced:
            with tobs.tracing():
                reg.publish_packed("t", rows, alphas, clock=0.0)
                chain.finalize()
        else:
            reg.publish_packed("t", rows, alphas, clock=0.0)
            chain.finalize()
        return [b.hash for b in chain.blocks], reg.latest("t").fingerprint
    assert run(traced=True) == run(traced=False)
    assert _chain_spans(TC, tobs)[1] == _chain_spans(JC, jobs)[1]


# ---------------------------------------------------------- kernel profile
def _metrics_snapshot():
    """A registry snapshot in the JAX package's format: two backends timed
    on one (kernel, bucket), one on another, plus an unrelated entry."""
    hist = lambda p50, p99, n: {"count": n, "p50": p50, "p99": p99}
    return {
        "counters": {
            "kernel.launches{backend=interpret,bucket=8x64,kernel=vote}": 5,
            "kernel.launches{backend=xla,bucket=8x64,kernel=vote}": 7,
            "serve.requests": 12},
        "histograms": {
            "kernel.wall_s{backend=interpret,bucket=8x64,kernel=vote}":
                hist(2e-3, 4e-3, 5),
            "kernel.wall_s{backend=xla,bucket=8x64,kernel=vote}":
                hist(1e-3, 3e-3, 7),
            "kernel.wall_s{backend=xla,bucket=1x16,kernel=scan}":
                hist(5e-4, 6e-4, 2),
            "serve.latency_s": hist(1e-3, 2e-3, 12)}}


@pytest.mark.parametrize("winner", ["interpret", "xla", None])
def test_kernel_profile_equals_reference(tmp_path, winner):
    snap = _metrics_snapshot()
    path = None
    if winner is not None:
        path = tmp_path / "calibration.json"
        path.write_text(json.dumps({"table": [
            {"kernel": "vote", "bucket": [8, 64], "backend": winner},
            {"kernel": "scan", "bucket": [1, 16], "backend": "xla"}]}))
        path = str(path)
    rows, warns = T.kernel_profile(snap, path)
    assert (rows, warns) == J.kernel_profile(snap, path)
    assert [(r["kernel"], r["backend"], r["launches"]) for r in rows] == [
        ("vote", "interpret", 5), ("scan", "xla", 2), ("vote", "xla", 7)]
    assert len(warns) == (1 if winner == "interpret" else 0)


# --------------------------------------------------------------------- CLI
def test_cli_output_equals_reference(span_lists, tmp_path, capsys):
    spans = span_lists["fleet"]
    trace = tmp_path / "trace.jsonl"
    with trace.open("w") as f:
        f.write(json.dumps({"meta": {"schema": 2, "dropped": 0}}) + "\n")
        for s in spans:
            f.write(json.dumps(s) + "\n")
    metrics = tmp_path / "metrics.json"
    metrics.write_text(json.dumps(_metrics_snapshot()))
    outs = []
    for mod, tag in ((J, "ref"), (T, "port")):
        folded = tmp_path / f"{tag}.folded"
        rc = mod.main([str(trace), "--check", "--stitch", "auto",
                       "--metrics", str(metrics), "--calibration",
                       str(tmp_path / "none.json"), "--folded", str(folded)])
        out = capsys.readouterr().out.replace(str(folded), "OUT")
        outs.append((rc, out, folded.read_text()))
    assert outs[0] == outs[1]
    assert outs[1][0] == 0 and "trace OK" in outs[1][1]
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps(_span("child", 2, "tA", parent=1)) + "\n")
    assert T.main([str(bad), "--check"]) == J.main([str(bad), "--check"]) \
        == 1
    empty = tmp_path / "empty.jsonl"
    empty.write_text("")
    assert T.main([str(empty)]) == 2
    assert T.main([str(trace), "--stitch", "rid:99999"]) == 2


def test_exported_port_trace_loads_and_checks(span_lists, tmp_path):
    """A trace the port's tracer exports is one the port's reporter reads
    and passes."""
    with tobs.tracing() as tracer:
        cl = TC.ChainCluster(2, GossipConfig(seed=0))
        rows, alphas = _packed(5, seed=2)
        cl.publish_packed("t", rows, alphas, clock=0.0, owners=[0, 0, 1, 1,
                                                                2])
        cl.run_until_quiescent(1.0)
        path = tracer.export_jsonl(tmp_path / "chain.jsonl")
    meta, spans = tobs.load_trace(path)
    assert T.check_trace(spans, meta) == []
    commit = next(s for s in spans if s["name"] == "chain.commit")
    st = T.stitch_trace(spans, commit["trace"])
    assert {"host-0", "host-1"} <= {s["host"] for s in st["members"]
                                    if s["name"] == "chain.aggregate"}


# ------------------------------------------------------------ write_trace
def test_write_trace_round_trips(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_TRACES_DIR", str(tmp_path / "traces"))
    rec = ttraces.derive_diurnal_trace(n_segments=12, seed=3)
    path = ttraces.write_trace("phone_day", rec)
    assert path == tmp_path / "traces" / "phone_day.json"
    assert ttraces.load_trace("phone_day") == rec
    assert ttraces.available_traces() == ["phone_day"]
    from repro.sim import traces as jtraces
    assert json.loads(path.read_text()) == json.loads(
        jtraces.write_trace("phone_day_ref", rec).read_text())
