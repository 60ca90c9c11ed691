"""The port's SLO ledger and contribution audits against the JAX package's,
on the CPU.

``SLOMonitor`` fed one outcome stream in both packages must give the same
alert timeline, budgets, burn pressure and report; ``robust_z`` and the
audit's flags must be equal on the same records.  Each criterion of the
JAX package's ``tests/test_slo.py`` and ``tests/test_audit.py`` runs
against the port.  An audited run of the port's engine must be
bit-identical to an unaudited one in both modes and on both engine cores,
and its audit must record what the JAX package's audit records on the same
run: the same clients, staleness and outcomes, magnitudes and error deltas
within 1e-5.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.obs as jobs  # noqa: E402
import repro_torch.obs as obs  # noqa: E402
from repro.configs.paper_fedboost import DomainConfig  # noqa: E402
from repro.configs.paper_fedboost import (  # noqa: E402
    FedBoostConfig as JaxConfig)
from repro.core import FederatedBoostEngine as JaxEngine  # noqa: E402
from repro.data import make_domain_data  # noqa: E402
from repro.obs import audit as jaudit  # noqa: E402
from repro.obs import slo as jslo  # noqa: E402
from repro_torch.configs.paper_fedboost import FedBoostConfig  # noqa: E402
from repro_torch.convert import domain_data_from_numpy  # noqa: E402
from repro_torch.core import FederatedBoostEngine  # noqa: E402
from repro_torch.obs import audit as taudit  # noqa: E402
from repro_torch.obs import slo as tslo  # noqa: E402
from repro_torch.obs.registry import MetricsRegistry  # noqa: E402


def _obj(m, **kw):
    base = dict(tenant="t0", latency_threshold_s=0.02, target=0.95,
                window_s=1.0)
    base.update(kw)
    return m.SLObjective(**base)


# ------------------------------------------------------ SLO against the ref
def _stream(seed=0, n=900):
    """(tenant, t, latency or None, rejected) outcomes: calm, a burst of
    slow and shed requests on one tenant, then calm again."""
    rng = np.random.RandomState(seed)
    out, t = [], 0.0
    for i in range(n):
        t += float(rng.exponential(0.005))
        tenant = ("t0", "t1")[rng.randint(2)]
        burst = 1.5 < t < 2.2 and tenant == "t0"
        if burst and rng.rand() < 0.2:
            out.append((tenant, t, None, True))
        else:
            lat = float(rng.exponential(0.3 if burst else 0.004))
            out.append((tenant, t, lat, False))
    return out


def _drive_monitor(m, stream, rules=None):
    objs = [_obj(m, window_s=1.0), _obj(m, tenant="t1", target=0.99,
                                        latency_threshold_s=0.01,
                                        window_s=0.5)]
    journal = []
    mon = m.SLOMonitor(objs, rules=rules, journal=journal)
    events, pressure = [], []
    for i, (tenant, t, lat, rejected) in enumerate(stream):
        if rejected:
            mon.record(tenant, t, rejected=True)
        else:
            mon.record_completion(tenant, t, lat)
        if i % 5 == 0:
            events += [dataclasses.asdict(e) for e in mon.check(t)]
            pressure.append(mon.burn_pressure(t))
    t_end = stream[-1][1] + 3.0
    events += [dataclasses.asdict(e) for e in mon.check(t_end)]
    return dict(events=events, pressure=pressure, journal=journal,
                timeline=mon.alerts.timeline(), report=mon.report(t_end),
                remaining={t: mon.budget_remaining(t, t_end)
                           for t in ("t0", "t1")})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_monitor_alert_timeline_and_report_equal_reference(seed):
    stream = _stream(seed)
    want = _drive_monitor(jslo, stream)
    got = _drive_monitor(tslo, stream)
    assert got == want
    assert any(e["kind"] == "fire" for e in got["events"])


def test_custom_rules_and_default_rules_equal_reference():
    for window in (0.25, 1.0, 2.0, 60.0):
        assert ([dataclasses.asdict(r)
                 for r in tslo.default_rules(_obj(tslo, window_s=window))]
                == [dataclasses.asdict(r) for r in
                    jslo.default_rules(_obj(jslo, window_s=window))])
    stream = _stream(3, 400)
    rule = dict(name="only", long_s=0.5, short_s=0.1, factor=4.0)
    want = _drive_monitor(jslo, stream, [jslo.BurnRateRule(**rule)])
    got = _drive_monitor(tslo, stream, [tslo.BurnRateRule(**rule)])
    assert got == want


def test_monitor_counters_and_points_equal_reference():
    def run(m, o):
        with o.tracing() as tracer:
            mon = m.SLOMonitor([_obj(m, window_s=1.0)])
            for i in range(50):
                mon.record("t0", 0.01 * i, latency_s=0.5)
                mon.check(0.01 * i)
            snap = o.get_registry().snapshot()
            names = [s["name"] for s in tracer.finished()]
        return snap["counters"], sorted(snap["gauges"]), names
    assert run(tslo, obs) == run(jslo, jobs)


# ------------------------------------------------- the JAX package's criteria
def test_budget_fraction_is_target_complement():
    assert _obj(tslo, target=0.99).budget_fraction == pytest.approx(0.01)
    assert _obj(tslo, target=0.95).budget_fraction == pytest.approx(0.05)
    assert _obj(tslo, target=1.0).budget_fraction > 0.0


def test_default_rules_scale_with_window():
    page, ticket = tslo.default_rules(_obj(tslo, window_s=2.0))
    assert (page.long_s, page.short_s, page.factor) == (0.5, 0.125, 8.0)
    assert (ticket.long_s, ticket.short_s, ticket.factor) == (2.0, 0.5, 2.0)
    assert page.short_s < ticket.short_s and page.factor > ticket.factor


def test_error_budget_exact_totals_and_windowed_counts():
    b = tslo.ErrorBudget(_obj(tslo), horizon_s=1.0)
    for i in range(10):
        b.record(0.1 * i, good=(i % 2 == 0))
    assert (b.good_total, b.bad_total, b.total) == (5, 5, 10)
    good, bad = b.window_counts(0.9, 0.5)
    assert good + bad == 5
    b.record(100.0, good=True)
    assert b.window_counts(100.0, 0.5) == (1, 0)
    assert (b.good_total, b.bad_total) == (6, 5)


def test_burn_rate_in_budget_units():
    b = tslo.ErrorBudget(_obj(tslo, target=0.95), horizon_s=10.0)
    for i in range(100):
        b.record(0.01 * (i + 1), good=(i % 10 != 0))
    assert b.bad_fraction(1.0, 1.0) == pytest.approx(0.10)
    assert b.burn_rate(1.0, 1.0) == pytest.approx(2.0)
    assert b.remaining(1.0) == 0.0
    empty = tslo.ErrorBudget(_obj(tslo), horizon_s=1.0)
    assert empty.burn_rate(5.0, 1.0) == 0.0
    assert empty.remaining(5.0) == 1.0


def test_alert_log_fire_resolve_active_bookkeeping():
    log = tslo.AlertLog()
    f = tslo.AlertEvent(1.0, "t0", "page", "fire", 10.0, 9.0)
    log.fire(f)
    assert log.is_active("t0", "page") and log.active() == [f]
    log.resolve(tslo.AlertEvent(2.0, "t0", "page", "resolve", 0.5, 4.0))
    assert not log.is_active("t0", "page") and log.active() == []
    assert [e["kind"] for e in log.timeline()] == ["fire", "resolve"]


def test_monitor_fires_during_burst_and_resolves_after():
    mon = tslo.SLOMonitor([_obj(tslo, window_s=1.0)])
    t = 0.0
    while t < 2.0:
        mon.record("t0", t, latency_s=0.005)
        assert mon.check(t) == []
        t += 0.01
    fired = []
    while t < 2.5:
        mon.record("t0", t, latency_s=0.5)
        fired += mon.check(t)
        t += 0.01
    assert any(e.kind == "fire" for e in fired) and mon.alerts.active()
    resolved = []
    while t < 4.5:
        mon.record("t0", t, latency_s=0.005)
        resolved += mon.check(t)
        t += 0.01
    assert any(e.kind == "resolve" for e in resolved)
    assert not mon.alerts.active()
    events = mon.alerts.timeline()
    assert (sum(e["kind"] == "fire" for e in events)
            == sum(e["kind"] == "resolve" for e in events))


def test_monitor_rejections_burn_budget_and_journal_is_exact():
    journal = []
    mon = tslo.SLOMonitor([_obj(tslo)], journal=journal)
    assert mon.record("t0", 0.0, latency_s=0.001) is True
    assert mon.record("t0", 0.1, latency_s=0.5) is False
    assert mon.record("t0", 0.2, rejected=True) is False
    assert mon.record("t0", 0.3) is False
    b = mon.budgets["t0"]
    assert (b.good_total, b.bad_total) == (1, 3)
    assert [e["good"] for e in journal] == [True, False, False, False]
    assert journal[2]["rejected"] is True
    assert mon.record("nobody", 0.4, latency_s=9.9) is True
    assert len(journal) == 4


def test_monitor_requires_objectives_and_burn_pressure_crosses_one():
    with pytest.raises(ValueError):
        tslo.SLOMonitor([])
    mon = tslo.SLOMonitor([_obj(tslo, window_s=1.0)])
    assert mon.burn_pressure(0.0) == 0.0
    for i in range(50):
        mon.record("t0", 0.01 * i, latency_s=0.5)
    assert mon.burn_pressure(0.5) >= 1.0
    assert mon.budget_remaining("t0", 0.5) == 0.0


def test_report_shape():
    mon = tslo.SLOMonitor([_obj(tslo)])
    mon.record("t0", 0.0, latency_s=0.001)
    rep = mon.report(0.5)
    assert rep["tenants"]["t0"]["good"] == 1
    assert rep["tenants"]["t0"]["bad"] == 0
    assert rep["alerts"] == [] and rep["active_alerts"] == []


# --------------------------------------------------- audit against the ref
def _audit_records(seed, n_clients=9, poisoner=8):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(20):
        for cid in range(n_clients):
            bad = cid == poisoner
            out.append((cid, dict(
                magnitude=25.0 if bad else 0.5 + 0.01 * rng.randn(),
                error_delta=-0.05 if bad else 0.01 + 1e-3 * rng.randn(),
                staleness=float(rng.randint(0, 3)),
                outcome="rejected" if rng.rand() < 0.05 else "merged")))
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_robust_z_and_flags_equal_reference(seed):
    rng = np.random.RandomState(seed)
    for n in (0, 1, 2, 3, 7, 40):
        vals = {i: float(rng.randn()) for i in range(n)}
        if n > 3:
            vals[n - 1] = 50.0
        assert taudit.robust_z(vals) == jaudit.robust_z(vals)
    assert (taudit.robust_z({i: 1.0 for i in range(6)})
            == jaudit.robust_z({i: 1.0 for i in range(6)}))
    ja = jaudit.ContributionAudit(registry=jobs.MetricsRegistry(), window=8)
    ta = taudit.ContributionAudit(registry=MetricsRegistry(), window=8)
    for cid, rec in _audit_records(seed):
        ja.record(cid, **rec)
        ta.record(cid, **rec)
    assert ta.summary() == ja.summary()
    for metric in (None, "magnitude", "error_delta", "staleness"):
        assert ([f.to_dict() for f in ta.flags(metric)]
                == [f.to_dict() for f in ja.flags(metric)])
    assert ta.registry.snapshot() == ja.registry.snapshot()


def test_robust_z_flags_the_lone_outlier():
    values = {i: 1.0 + 0.01 * (i % 3) for i in range(9)}
    values[9] = 50.0
    zs = taudit.robust_z(values)
    assert abs(zs[9]) > 3.5
    assert all(abs(z) <= 3.5 for cid, z in zs.items() if cid != 9)


def test_robust_z_degenerate_cases():
    assert taudit.robust_z({0: 1.0, 1: 99.0}) == {0: 0.0, 1: 0.0}
    assert set(taudit.robust_z({i: 2.0 for i in range(5)}).values()) == {0.0}
    vals = {i: 1.0 for i in range(6)}
    vals[6] = 100.0
    assert abs(taudit.robust_z(vals)[6]) > 3.5


def test_audit_records_stats_and_instruments():
    reg = MetricsRegistry()
    audit = taudit.ContributionAudit(registry=reg, window=4)
    for i in range(6):
        audit.record(0, magnitude=0.5, error_delta=0.01, staleness=float(i))
    audit.record(1, magnitude=0.2, error_delta=-0.02, staleness=1.0,
                 outcome="rejected")
    st = audit.clients[0]
    assert st.merges == 6 and len(st.staleness) == 4
    assert st.mean("staleness") == pytest.approx((2 + 3 + 4 + 5) / 4)
    assert audit.clients[1].outcomes == {"rejected": 1}
    assert audit.recorded == 7
    snap = reg.snapshot()
    assert snap["counters"]["audit.outcomes{cid=0,outcome=merged}"] == 6.0
    assert snap["counters"]["audit.outcomes{cid=1,outcome=rejected}"] == 1.0
    assert "audit.update_magnitude{cid=0}" in snap["histograms"]
    assert "audit.staleness{cid=1}" in snap["histograms"]


def test_audit_flags_poisoning_client():
    audit = taudit.ContributionAudit(registry=MetricsRegistry())
    rng = np.random.RandomState(0)
    for cid in range(8):
        for _ in range(20):
            audit.record(cid, magnitude=0.5 + 0.01 * rng.randn(),
                         error_delta=0.01, staleness=1.0)
    for _ in range(20):
        audit.record(8, magnitude=25.0, error_delta=-0.05, staleness=1.0)
    flagged = {(f.cid, f.metric) for f in audit.flags()}
    assert (8, "magnitude") in flagged and (8, "error_delta") in flagged
    assert all(cid == 8 for cid, _ in flagged)
    assert {f.metric for f in audit.flags("magnitude")} == {"magnitude"}
    summ = audit.summary()
    assert summ["recorded"] == 9 * 20
    assert any(f["cid"] == 8 for f in summ["flags"])


def test_audit_default_registry_follows_obs_scope():
    audit = obs.ContributionAudit()
    with obs.tracing():
        audit.record(0, magnitude=1.0, error_delta=0.0, staleness=0.0)
        snap = obs.get_registry().snapshot()
        assert "audit.update_magnitude{cid=0}" in snap["histograms"]
    outer = obs.get_registry().snapshot()
    assert "audit.update_magnitude{cid=0}" not in outer["histograms"]


def test_audit_flag_to_dict_roundtrip():
    f = obs.AuditFlag(cid=3, metric="magnitude", z=4.2, value=9.0, median=1.0)
    assert f.to_dict() == {"cid": 3, "metric": "magnitude", "z": 4.2,
                           "value": 9.0, "median": 1.0}


# ------------------------------------------------------ engine integration
DOM = DomainConfig(name="mobile", n_samples=900, n_features=10, n_clients=6,
                   noniid_alpha=0.5, label_imbalance=0.5, noise=0.15,
                   straggler_factor=3.0, dropout_prob=0.1, link_mbps=5.0)


@pytest.fixture(scope="module")
def jdata():
    return make_domain_data(DOM, seed=0, partitioner="iid")


def _cfg_kw():
    return dict(n_clients=DOM.n_clients, n_rounds=4,
                straggler_factor=DOM.straggler_factor,
                dropout_prob=DOM.dropout_prob, seed=0)


def _engine(jdata, mode="enhanced", engine="events", fleet=None):
    data = domain_data_from_numpy(jdata["clients"], jdata["val"],
                                  jdata["test"])
    return FederatedBoostEngine(FedBoostConfig(**_cfg_kw()), data, mode,
                                engine=engine, fleet=fleet, device="cpu")


def _same_run(a, b):
    for k in ("uplink_bytes", "downlink_bytes", "n_messages", "n_syncs",
              "learners_merged", "rounds_unavailable", "sim_time_s",
              "final_val_error", "final_test_error", "final_test_recall"):
        assert getattr(a, k) == getattr(b, k), k
    assert a.val_error_curve == b.val_error_curve


@pytest.mark.parametrize("engine", ["loop", "events"])
@pytest.mark.parametrize("mode", ["baseline", "enhanced"])
def test_audit_is_pure_measurement(jdata, mode, engine):
    plain_eng = _engine(jdata, mode, engine)
    plain = plain_eng.run()
    audited_eng = _engine(jdata, mode, engine)
    audit = audited_eng.attach_audit()
    audited = audited_eng.run()
    _same_run(plain, audited)
    assert plain_eng.ensemble.alphas == audited_eng.ensemble.alphas
    assert audit.recorded == audited.learners_merged
    assert sum(st.outcomes.get("merged", 0)
               for st in audit.clients.values()) == audited.learners_merged
    assert all(0 <= cid < DOM.n_clients for cid in audit.clients)
    for st in audit.clients.values():
        assert all(s >= 0 for s in st.staleness)
        assert all(np.isfinite(m) for m in st.magnitude)


@pytest.mark.parametrize("engine", ["loop", "events"])
def test_attached_audit_records_like_reference(jdata, engine):
    jeng = JaxEngine(JaxConfig(**_cfg_kw()), jdata, "enhanced",
                     engine=engine)
    ja = jeng.attach_audit(jaudit.ContributionAudit(
        registry=jobs.MetricsRegistry()))
    jm = jeng.run()
    teng = _engine(jdata, "enhanced", engine)
    ta = teng.attach_audit(taudit.ContributionAudit(
        registry=MetricsRegistry()))
    tm = teng.run()
    for k in ("total_bytes", "n_messages", "n_syncs", "learners_merged"):
        assert getattr(tm, k) == getattr(jm, k), k
    assert ta.recorded == ja.recorded == tm.learners_merged
    assert sorted(ta.clients) == sorted(ja.clients)
    for cid, jst in ja.clients.items():
        tst = ta.clients[cid]
        assert (tst.merges, list(tst.staleness), tst.outcomes) == (
            jst.merges, list(jst.staleness), jst.outcomes)
        np.testing.assert_allclose(list(tst.magnitude), list(jst.magnitude),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(list(tst.error_delta),
                                   list(jst.error_delta), rtol=0, atol=1e-5)
    assert ([(f.cid, f.metric) for f in ta.flags()]
            == [(f.cid, f.metric) for f in ja.flags()])


def test_fleet_profile_refuses_audit(jdata):
    eng = _engine(jdata, fleet=True)
    with pytest.raises(ValueError, match="fleet"):
        eng.attach_audit()


def test_attach_audit_accepts_external_instance(jdata):
    audit = taudit.ContributionAudit(registry=MetricsRegistry(), window=8)
    eng = _engine(jdata)
    assert eng.attach_audit(audit) is audit
    eng.run()
    assert audit.recorded > 0
