"""The port's simulator layer against the JAX package's, on the CPU: the
behavior models draw the same numbers at the same seeds, the scenario
registry holds the same scenarios field for field, the recorded traces are
read alike, and the train half of the harness gives the same result row.
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.sim import behavior as jbeh  # noqa: E402
from repro.sim import harness as jharness  # noqa: E402
from repro.sim import scenarios as jscen  # noqa: E402
from repro.sim import traces as jtraces  # noqa: E402
from repro_torch.launch import run_scenario as cli  # noqa: E402
from repro_torch.sim import behavior as tbeh  # noqa: E402
from repro_torch.sim import harness as tharness  # noqa: E402
from repro_torch.sim import scenarios as tscen  # noqa: E402
from repro_torch.sim import traces as ttraces  # noqa: E402


def draws(beh, n=60, seed=0):
    """A behavior's answers along a non-decreasing clock."""
    out = []
    t = 0.0
    steps = np.random.RandomState(seed).exponential(0.7, size=n)
    for dt in steps:
        t += float(dt)
        link = beh.link(t)
        out.append((beh.availability(t), beh.compute_time(1.0, t),
                    beh.stall_time(1.0, t), link.latency_s,
                    link.bandwidth_mbps, beh.query_delay(t)))
    return out


def pair(build):
    """``build(module)`` for both packages' behavior modules."""
    return build(jbeh), build(tbeh)


BEHAVIORS = {
    "legacy": lambda m: m.LegacyBehavior(2.5, 0.3, 5.0, 0.05,
                                         np.random.RandomState(1)),
    "diurnal": lambda m: m.DiurnalBehavior(
        1.7, 24.0, 3.0, np.random.RandomState(2), peak=0.9, trough=0.2),
    "gilbert": lambda m: m.GilbertLinkBehavior(
        1.3, np.random.RandomState(3), mean_good_s=4.0, mean_bad_s=2.0),
    "site": lambda m: m.SiteBehavior(
        m.SiteOutageProcess(np.random.RandomState(4), mean_up_s=5.0,
                            mean_down_s=2.0), 1.5),
    "block_delay": lambda m: m.BlockDelayBehavior(
        1.2, np.random.RandomState(5), ledger=m.BlockchainLedger(
            np.random.RandomState(6), prune_every=4)),
    "block_iid": lambda m: m.BlockDelayBehavior(
        1.2, np.random.RandomState(7), congestion_prob=0.5),
    "trace": lambda m: m.TraceSchedule.from_json(
        m.TraceSchedule.from_json(
            jscen.BATTERY_TRACE_JSON, phase_s=1.3).to_json(),
        base=m.LegacyBehavior(1.4, 0.2, 5.0, 0.05,
                              np.random.RandomState(8))),
}


@pytest.mark.parametrize("name", sorted(BEHAVIORS))
def test_behavior_draws_equal_reference(name):
    ref, port = pair(BEHAVIORS[name])
    assert draws(port) == draws(ref)


def test_legacy_behaviors_draw_like_reference():
    cfg = tscen.get_scenario("iot").fedboost_config()
    ref = jbeh.legacy_behaviors(cfg, 6, np.random.RandomState(0))
    port = tbeh.legacy_behaviors(cfg, 6, np.random.RandomState(0))
    for a, b in zip(ref, port):
        assert draws(b, 10) == draws(a, 10)


def test_registry_holds_the_reference_scenarios():
    assert list(tscen.SCENARIOS) == list(jscen.SCENARIOS)
    assert tscen.base_scenarios() == jscen.base_scenarios()
    assert tscen.variant_scenarios() == jscen.variant_scenarios()
    for name, jsc in jscen.SCENARIOS.items():
        tsc = tscen.get_scenario(name)
        for f in dataclasses.fields(jsc):
            a, b = getattr(jsc, f.name), getattr(tsc, f.name)
            if f.name == "traces":
                assert sorted(a) == sorted(b), name
            elif f.name == "config_overrides":
                assert ({k: repr(v) for k, v in a.items()}
                        == {k: repr(v).replace("repro_torch.", "repro.")
                            for k, v in b.items()}), name
            elif dataclasses.is_dataclass(a):
                assert dataclasses.asdict(a) == dataclasses.asdict(b), name
            else:
                assert a == b, (name, f.name)
        assert (dataclasses.asdict(jsc.fedboost_config(seed=3, n_rounds=5))
                == dataclasses.asdict(tsc.fedboost_config(seed=3,
                                                          n_rounds=5)))
    big = tscen.get_scenario("mobile_100k")
    assert big.fleet and not big.serve_replay
    assert big.domain.n_clients == 100_000 and big.n_rounds == 4
    assert {k: dataclasses.asdict(v) for k, v in tscen.DOMAINS.items()} == {
        k: dataclasses.asdict(v) for k, v in jscen.DOMAINS.items()}
    assert tscen.PAPER_BANDS == jscen.PAPER_BANDS


def _scenario_traces():
    for name, sc in jscen.SCENARIOS.items():
        for trace in sorted(sc.traces):
            # 100k behaviors per factory call: the legacy trace only
            if sc.domain.n_clients > 1000 and trace != "legacy":
                continue
            yield name, trace


@pytest.mark.parametrize("name,trace", list(_scenario_traces()))
def test_trace_factories_build_the_reference_behaviors(name, trace):
    ref = jscen.get_scenario(name).behavior_for(trace, seed=2)
    port = tscen.get_scenario(name).behavior_for(trace, seed=2)
    if ref is None:
        assert port is None                     # the engine's legacy shim
        return
    n = jscen.get_scenario(name).domain.n_clients
    for cid in sorted({0, 1, n // 2, n - 1}):
        assert draws(port(cid), 25, cid) == draws(ref(cid), 25, cid), cid


def test_recorded_trace_reads_like_reference():
    assert ttraces.available_traces() == jtraces.available_traces()
    assert ttraces.load_trace("mobile_diurnal") == jtraces.load_trace(
        "mobile_diurnal")
    # the checked-in recording is its derivation
    derived = ttraces.derive_diurnal_trace()
    assert derived["segments"] == ttraces.load_trace(
        "mobile_diurnal")["segments"]
    assert derived == jtraces.derive_diurnal_trace()


def test_scenario_data_equal_reference():
    for name in ("healthcare", "iot"):
        jd = jscen.get_scenario(name).make_data(1)
        td = tscen.get_scenario(name).make_data(1)
        assert len(jd["clients"]) == len(td["clients"])
        for (jx, jy), (tx, ty) in zip(jd["clients"] + [jd["val"]],
                                      td["clients"] + [td["val"]]):
            np.testing.assert_array_equal(np.asarray(jx), tx)
            np.testing.assert_array_equal(np.asarray(jy), ty)


def test_result_row_equal_reference():
    # healthcare on 4 equal iid shards: one shard shape to compile
    def small(sc):
        return dataclasses.replace(sc, partitioner="iid", domain=(
            dataclasses.replace(sc.domain, n_samples=800, n_clients=4)))
    _, jruns = jharness.train_pair(small(jscen.get_scenario("healthcare")),
                                   "maintenance", seed=0, n_rounds=5)
    _, truns = tharness.train_pair(small(tscen.get_scenario("healthcare")),
                                   "maintenance", seed=0, n_rounds=5,
                                   device="cpu")
    for mode in ("baseline", "enhanced"):
        j, t = jruns[mode], truns[mode]
        for k in ("total_bytes", "n_messages", "n_syncs",
                  "learners_merged", "rounds_unavailable", "sim_time_s",
                  "final_test_error"):
            assert getattr(j, k) == getattr(t, k), (mode, k)
        assert [c[:2] for c in j.val_error_curve] == [
            c[:2] for c in t.val_error_curve]
    want = jharness.result_row(jruns)
    got = tharness.result_row(truns)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert math.isclose(got[k], v, rel_tol=1e-9, abs_tol=1e-9), k
    # the row is a function of the metrics alone: the same metrics give
    # the same row in both packages
    assert tharness.result_row(jruns) == want


def test_run_scenario_trains_and_refuses_the_unported_replay():
    """Every scenario that replays serving serves, the chain scenario
    too: its replay kills the committee leader halfway and reports the
    host; with ``serve=False`` it trains only."""
    chain = tharness.run_scenario("blockchain_flchain", n_rounds=2,
                                  serve_duration_s=0.5, device="cpu")
    assert chain.serve["killed_host"] in ("host-0", "host-1")
    assert chain.serve["completed"] > 0 and chain.serve["rejected"] == 0
    chain = tharness.run_scenario("blockchain_flchain", n_rounds=2,
                                  serve=False, device="cpu")
    assert chain.serve is None and chain.enhanced.learners_merged > 0
    served = [n for n, sc in tscen.SCENARIOS.items() if sc.serve_replay]
    assert "blockchain_flchain" in served and "iot" in served
    assert served == [n for n, sc in jscen.SCENARIOS.items()
                      if sc.serve_replay]
    rep = tharness.run_scenario("healthcare", trace="maintenance",
                                n_rounds=3, serve_duration_s=0.5,
                                device="cpu")
    assert set(rep.serve) == {
        "offered", "offline_suppressed", "completed", "rejected", "p50_ms",
        "p99_ms", "throughput_rps", "mean_batch", "cache_hit_rate",
        "snapshot_version", "hosts_final", "scale_outs", "scale_ins",
        "rerouted", "killed_host", "slo"}
    assert rep.serve["completed"] > 0
    assert rep.serve["snapshot_version"] == rep.enhanced.snapshots_published
    rep = tharness.run_scenario("iot", trace="gilbert", n_rounds=3,
                                serve=False, device="cpu")
    assert rep.serve is None
    assert rep.row["comm_down"] != 0.0
    assert rep.within_band == (not rep.band_failures)
    assert "scenario iot · trace gilbert" in tharness.summarize(rep)


def test_run_scenario_cli(capsys):
    assert cli.main(["--list"]) == 0
    out = capsys.readouterr().out
    assert "mobile_100k" in out and "blockchain_flchain" in out
    rc = cli.main(["blockchain_flchain", "--trace", "block_delay",
                   "--rounds", "2", "--serve-duration", "0.5", "--device",
                   "cpu"])
    assert rc in (0, 1)
    out = capsys.readouterr().out
    assert "scenario blockchain_flchain · trace block_delay" in out
    assert "serve:" in out and "(1 out / 1 in" in out
    rc = cli.main(["iot", "--trace", "gilbert", "--rounds", "3", "--hosts",
                   "3", "--serve-duration", "0.5", "--device", "cpu"])
    assert rc in (0, 1)
    out = capsys.readouterr().out
    assert "scenario iot · trace gilbert" in out
    assert "serve:" in out and "hosts 3 (0 out / 0 in" in out
    rc = cli.main(["healthcare", "--trace", "maintenance", "--rounds", "3",
                   "--serve-duration", "0.5", "--no-autoscale", "--device",
                   "cpu"])
    assert rc in (0, 1)
    out = capsys.readouterr().out
    assert "scenario healthcare · trace maintenance" in out
    assert "serve:" in out and "hosts 2 (0 out / 0 in" in out
    rc = cli.main(["healthcare", "--trace", "maintenance", "--rounds", "3",
                   "--no-serve", "--device", "cpu"])
    assert rc in (0, 1)
    out = capsys.readouterr().out
    assert "scenario healthcare · trace maintenance" in out
    assert "serve:" not in out
