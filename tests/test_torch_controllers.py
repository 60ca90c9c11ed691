"""The port's beyond-paper interval controllers
(``repro_torch.core.controllers``) against the JAX package's, on the CPU.

Both controllers meet the safety property of eq. 1 (the interval stays
within [i_min, i_max]) and, fed the same error stream, give the reference's
interval at every step.  Swapped into each package's engine in place of
eq. 1 (``engine.scheduler = ...``), a lockstep run — the port's engine
handed the reference's stump at every fit (ROADMAP C4) — must give every
counter and the event clock of the reference's run exactly, and the same
interval at every sync.
"""
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("hypothesis")

from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.configs.paper_fedboost import (  # noqa: E402
    FedBoostConfig as JaxConfig)
from repro.configs.paper_fedboost import (  # noqa: E402
    SchedulerConfig as JaxSchedulerConfig)
from repro.core import FederatedBoostEngine as JaxEngine  # noqa: E402
from repro.core import controllers as J  # noqa: E402
from repro.data import make_domain_data as jax_domain_data  # noqa: E402
from repro.models import weak as jweak  # noqa: E402
from repro.sim.scenarios import DOMAINS  # noqa: E402
from repro_torch.configs.paper_fedboost import (  # noqa: E402
    FedBoostConfig, SchedulerConfig)
from repro_torch.convert import domain_data_from_numpy  # noqa: E402
from repro_torch.core import FederatedBoostEngine  # noqa: E402
from repro_torch.core import controllers as T  # noqa: E402
from repro_torch.models import weak  # noqa: E402

CFG = SchedulerConfig()
JCFG = JaxSchedulerConfig()
NAMES = ("TrendScheduler", "BudgetScheduler")
COUNTERS = ("uplink_bytes", "downlink_bytes", "n_messages", "n_syncs",
            "learners_merged", "snapshots_published", "rounds_unavailable",
            "sim_time_s")
LOCKSTEP_ROUNDS = 10               # edge_vision's 25 cut to keep this short


@pytest.mark.parametrize("name", NAMES)
@given(st.lists(st.floats(min_value=0.0, max_value=1.0), min_size=1,
                max_size=60))
@settings(max_examples=40, deadline=None)
def test_bounded_interval_and_equal_to_reference(name, errors):
    s, r = getattr(T, name)(CFG), getattr(J, name)(JCFG)
    for e in errors:
        got = s.observe(e)
        assert CFG.i_min <= s.interval <= CFG.i_max
        assert got == r.observe(e) and s.interval == r.interval
        assert s.current == r.current == got


def test_trend_widens_on_improvement_holds_on_plateau():
    s = T.TrendScheduler(CFG)
    s.observe(0.5)
    for e in (0.45, 0.4, 0.35, 0.3):
        s.observe(e)
    assert s.interval > 1.0
    level = s.interval
    for _ in range(5):
        s.observe(0.3)
    assert s.interval == pytest.approx(level, abs=1.0)


def test_budget_shrinks_on_regression():
    s = T.BudgetScheduler(CFG)
    s.interval = 8.0
    s.observe(0.2)
    for e in (0.3, 0.4, 0.5):
        s.observe(e)
    assert s.interval < 8.0


def _recording(sched, seen):
    """``sched`` with every interval it hands back recorded."""
    observe = sched.observe

    def recorded(error):
        out = observe(error)
        seen.append((error, out))
        return out
    sched.observe = recorded
    return sched


@pytest.mark.parametrize("name", NAMES)
def test_lockstep_engine_with_controller_equals_reference(name):
    dom = DOMAINS["edge_vision"]
    jdata = jax_domain_data(dom, seed=0)
    kw = dict(n_clients=dom.n_clients, n_rounds=LOCKSTEP_ROUNDS,
              straggler_factor=dom.straggler_factor,
              dropout_prob=dom.dropout_prob, link_mbps=dom.link_mbps)
    jbase = jweak.get_weak_learner("stump")
    picks = []

    def jfit(x, y, w, key):
        p = jbase.fit(x, y, w, key)
        picks.append((int(p["feature"]), float(p["threshold"]),
                      float(p["polarity"])))
        return p
    jcfg = JaxConfig(**kw)
    jeng = JaxEngine(jcfg, jdata, "enhanced",
                     weak=jweak.WeakLearnerSpec("stump", jfit, jbase.predict,
                                                jbase.param_bytes))
    jseen = []
    jeng.scheduler = _recording(getattr(J, name)(jcfg.scheduler), jseen)
    jm = jeng.run()

    base = weak.get_weak_learner("stump")
    replay = iter(picks)

    def lockstep_fit(x, y, w, generator=None):
        f, th, pol = next(replay)
        return {"feature": torch.tensor(f, dtype=torch.int32),
                "threshold": torch.tensor(th, dtype=torch.float32),
                "polarity": torch.tensor(pol, dtype=torch.float32)}
    cfg = FedBoostConfig(**kw)
    data = domain_data_from_numpy(jdata["clients"], jdata["val"],
                                  jdata["test"])
    eng = FederatedBoostEngine(
        cfg, data, "enhanced", device="cpu",
        weak=weak.WeakLearnerSpec("stump", lockstep_fit, base.predict,
                                  base.param_bytes))
    seen = []
    eng.scheduler = _recording(getattr(T, name)(cfg.scheduler), seen)
    m = eng.run()
    assert next(replay, None) is None
    for c in COUNTERS:
        assert getattr(m, c) == getattr(jm, c), c
    assert [i for _, i in seen] == [i for _, i in jseen]
    assert len(seen) == m.n_syncs > 0
    assert all(cfg.scheduler.i_min <= i <= cfg.scheduler.i_max
               for _, i in seen)
    for (e, _), (je, _) in zip(seen, jseen):
        assert abs(e - je) <= 1.0 / len(data["val"][1]) + 1e-6
    assert abs(m.final_test_error - jm.final_test_error) <= (
        1.0 / len(data["test"][1]) + 1e-6)
