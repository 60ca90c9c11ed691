"""Every (scenario, trace) pair that ``tests/test_torch_replay.py`` leaves
out, through both packages' ``run_scenario`` on the CPU.

The cut: seed 0, 2 rounds, at most 8 clients of 100 samples each, a 0.5 s
replay.  The JAX package runs each pair once, its stump picks recorded.
The port runs it twice: on its own, and in lockstep, handed the
reference's stump at every fit.  Both runs must give every replay field
(the snapshot version and the killed host included; floats to 1e-9
relative) and every training counter and ``sim_time_s`` of both modes
exactly.  The lockstep run must also give the reference's test errors to
one sample; the port's own run may differ there, where a pick settles an
exact tie (ROADMAP C4).
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from repro.models import weak as jweak  # noqa: E402
from repro.sim import harness as jharness  # noqa: E402
from repro.sim import scenarios as jscen  # noqa: E402
from repro_torch.models import weak as tweak  # noqa: E402
from repro_torch.sim import harness as tharness  # noqa: E402
from repro_torch.sim import scenarios as tscen  # noqa: E402

PAIRS = [("edge_vision", "rush_hour"), ("blockchain", "block_delay"),
         ("blockchain", "congestion"), ("mobile", "diurnal"),
         ("mobile", "battery_trace"), ("mobile", "diurnal_trace"),
         ("iot", "duty_cycle"), ("healthcare", "night_shift"),
         ("edge_vision_churn", "churn"), ("iot_coldstart", "staggered_join"),
         ("mobile_x4", "diurnal")]
ROUNDS, DURATION, MAX_CLIENTS, PER_CLIENT = 2, 0.5, 8, 100
COUNTERS = ("uplink_bytes", "downlink_bytes", "n_messages", "n_syncs",
            "learners_merged", "snapshots_published", "rounds_unavailable",
            "sim_time_s")
REL = 1e-9


def _cut(module, name):
    sc = module.get_scenario(name)
    k = min(MAX_CLIENTS, sc.domain.n_clients)
    return dataclasses.replace(sc, domain=dataclasses.replace(
        sc.domain, n_clients=k, n_samples=PER_CLIENT * k))


def _key(p):
    return (int(p["feature"]), float(p["threshold"]), float(p["polarity"]))


def _run(module, harness, name, trace, engine_cls=None, monkeypatch=None):
    if engine_cls is not None:
        monkeypatch.setattr(harness, "FederatedBoostEngine", engine_cls)
    kw = {} if module is jscen else {"device": "cpu"}
    rep = harness.run_scenario(_cut(module, name), trace=trace, seed=0,
                               n_rounds=ROUNDS, serve_duration_s=DURATION,
                               **kw)
    if engine_cls is not None:
        monkeypatch.undo()
    return rep


def _reference(name, trace, monkeypatch):
    """The JAX package's run, with each engine's stump picks recorded in
    the order the engines were built (baseline, then enhanced)."""
    picks = []
    base = jweak.get_weak_learner("stump")

    class Recording(jharness.FederatedBoostEngine):
        def __init__(self, *a, **kw):
            mine = []
            picks.append(mine)

            def fit(x, y, w, key):
                p = base.fit(x, y, w, key)
                mine.append(_key(p))
                return p
            kw["weak"] = jweak.WeakLearnerSpec("stump", fit, base.predict,
                                               base.param_bytes)
            super().__init__(*a, **kw)
    rep = _run(jscen, jharness, name, trace, Recording, monkeypatch)
    return rep, picks


def _lockstep(name, trace, picks, monkeypatch):
    base = tweak.get_weak_learner("stump")
    runs = iter(picks)
    replays = []

    class Lockstep(tharness.FederatedBoostEngine):
        def __init__(self, *a, **kw):
            replay = iter(next(runs))
            replays.append(replay)

            def fit(x, y, w, generator=None):
                f, th, pol = next(replay)
                return {"feature": torch.tensor(f, dtype=torch.int32),
                        "threshold": torch.tensor(th, dtype=torch.float32),
                        "polarity": torch.tensor(pol, dtype=torch.float32)}
            kw["weak"] = tweak.WeakLearnerSpec("stump", fit, base.predict,
                                               base.param_bytes)
            super().__init__(*a, **kw)
    rep = _run(tscen, tharness, name, trace, Lockstep, monkeypatch)
    assert next(runs, None) is None
    assert all(next(r, None) is None for r in replays)   # every pick used
    return rep


def _assert_equal(got, want, label):
    assert got.keys() == want.keys(), label
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_equal(got[k], w, f"{label}.{k}")
        elif isinstance(w, float):
            assert math.isclose(got[k], w, rel_tol=REL, abs_tol=0.0), (
                label, k, got[k], w)
        else:
            assert got[k] == w, (label, k, got[k], w)


@pytest.mark.parametrize("name,trace", PAIRS, ids=[f"{n}-{t}"
                                                   for n, t in PAIRS])
def test_replay_pair_equals_reference(name, trace, monkeypatch):
    ref, picks = _reference(name, trace, monkeypatch)
    assert len(picks) == 2
    lock = _lockstep(name, trace, picks, monkeypatch)
    own = _run(tscen, tharness, name, trace)
    assert ref.serve is not None and ref.serve["completed"] > 0
    for label, rep in (("lockstep", lock), ("own", own)):
        _assert_equal(rep.serve, ref.serve, f"{name}/{trace} {label}")
        for mode in ("baseline", "enhanced"):
            jm, tm = getattr(ref, mode), getattr(rep, mode)
            for c in COUNTERS:
                assert getattr(tm, c) == getattr(jm, c), (label, mode, c)
    one = 1.0 / len(_cut(tscen, name).make_data(0)["test"][1]) + 1e-6
    for mode in ("baseline", "enhanced"):
        jm, tm = getattr(ref, mode), getattr(lock, mode)
        assert abs(tm.final_test_error - jm.final_test_error) <= one, mode
        assert abs(tm.final_val_error - jm.final_val_error) <= one, mode
