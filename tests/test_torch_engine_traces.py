"""The port's engine against the JAX package's under the scenario traces.

The JAX package pins its event core to its loop core under stateful
behavior traces (``tests/test_engine_parity.py``); the port's engine
tests (``tests/test_torch_engine.py``) run the legacy trace only.  Here
five (scenario, trace) pairs — iot/gilbert, edge_vision/rack_outage,
blockchain/block_delay, mobile/diurnal, healthcare/maintenance — run in
both modes on both packages, on the CPU.

The port runs in lockstep: handed the JAX package's stump at every fit
(after checking that the fit is on the same shard, the distribution within
1e-4 relative), so a rounding tie in the pick (ROADMAP C4) cannot split
the runs.  Scheduling, compensation, the behaviors, the accounting and the
event clock are the port's own, and every counter and ``sim_time_s`` must
equal the reference's exactly.  The port's own events and loop cores must
also agree bit for bit under each trace.

Each domain is cut to 480 samples over 6 clients on equal ``iid``
shards (one shard shape for the JAX package to compile a domain) and 4
rounds, to hold the file near 30 s on one worker; the traces keep their
per-scenario parameters (blockchain's shared ledger, edge_vision's rack
outages).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import FederatedBoostEngine as JaxEngine  # noqa: E402
from repro.models import weak as jweak  # noqa: E402
from repro.sim import scenarios as jscen  # noqa: E402
from repro_torch.convert import domain_data_from_numpy  # noqa: E402
from repro_torch.core import FederatedBoostEngine  # noqa: E402
from repro_torch.models import weak  # noqa: E402
from repro_torch.sim import scenarios as tscen  # noqa: E402

PAIRS = [("iot", "gilbert"), ("edge_vision", "rack_outage"),
         ("blockchain", "block_delay"), ("mobile", "diurnal"),
         ("healthcare", "maintenance")]
N_SAMPLES, N_CLIENTS, ROUNDS, SEED = 480, 6, 4, 1
COUNTERS = ("uplink_bytes", "downlink_bytes", "n_messages", "n_syncs",
            "learners_merged", "snapshots_published", "rounds_unavailable")


def _small(module, name):
    sc = module.get_scenario(name)
    return dataclasses.replace(sc, partitioner="iid",
                               domain=dataclasses.replace(
                                   sc.domain, n_samples=N_SAMPLES,
                                   n_clients=N_CLIENTS))


def _key(p):
    return (int(p["feature"]), float(p["threshold"]), float(p["polarity"]))


def _reference(sc, trace, mode, jdata):
    """The JAX package's run, its stump recorded at every fit."""
    base = jweak.get_weak_learner("stump")
    fits = []

    def fit(x, y, w, key):
        p = base.fit(x, y, w, key)
        fits.append((np.asarray(x), np.asarray(y), np.asarray(w), _key(p)))
        return p
    spec = jweak.WeakLearnerSpec("stump", fit, base.predict,
                                 base.param_bytes)
    m = JaxEngine(sc.fedboost_config(seed=SEED, n_rounds=ROUNDS), jdata,
                  mode, weak=spec,
                  behavior_for=sc.behavior_for(trace, SEED)).run()
    return m, fits


def _lockstep(sc, trace, mode, data, fits):
    base = weak.get_weak_learner("stump")
    replay = iter(fits)
    count = [0]

    def fit(x, y, w, generator=None):
        jx, jy, jw, (f, th, pol) = next(replay)
        i = count[0]
        count[0] += 1
        assert np.array_equal(x.numpy(), jx) and np.array_equal(
            y.numpy(), jy), f"fit #{i} is on another shard than the ref's"
        np.testing.assert_allclose(w.numpy(), jw, rtol=1e-4, atol=1e-9,
                                   err_msg=f"distribution at fit #{i}")
        return {"feature": torch.tensor(f, dtype=torch.int32),
                "threshold": torch.tensor(th, dtype=torch.float32),
                "polarity": torch.tensor(pol, dtype=torch.float32)}
    spec = weak.WeakLearnerSpec("stump", fit, base.predict, base.param_bytes)
    m = FederatedBoostEngine(sc.fedboost_config(seed=SEED, n_rounds=ROUNDS),
                             data, mode, weak=spec,
                             behavior_for=sc.behavior_for(trace, SEED),
                             device="cpu").run()
    assert count[0] == len(fits)
    return m


@pytest.mark.parametrize("mode", ["baseline", "enhanced"])
@pytest.mark.parametrize("name,trace", PAIRS)
def test_lockstep_counters_and_clock_equal_reference(name, trace, mode):
    jsc, tsc = _small(jscen, name), _small(tscen, name)
    jdata = jsc.make_data(SEED)
    data = domain_data_from_numpy(jdata["clients"], jdata["val"],
                                  jdata["test"])
    jm, fits = _reference(jsc, trace, mode, jdata)
    tm = _lockstep(tsc, trace, mode, data, fits)
    diff = {k: (getattr(jm, k), getattr(tm, k)) for k in COUNTERS
            if getattr(jm, k) != getattr(tm, k)}
    assert not diff, f"{name}/{trace} {mode}: reference vs port {diff}"
    assert tm.sim_time_s == jm.sim_time_s
    assert [c[:2] for c in tm.val_error_curve] == [
        c[:2] for c in jm.val_error_curve]
    assert jm.learners_merged > 0 and len(fits) > 0

    # the port's own cores agree bit for bit under the same trace
    runs = {kind: FederatedBoostEngine(
        tsc.fedboost_config(seed=SEED, n_rounds=ROUNDS), data, mode,
        engine=kind, behavior_for=tsc.behavior_for(trace, SEED),
        device="cpu").run() for kind in ("events", "loop")}
    ev, lp = runs["events"], runs["loop"]
    for k in COUNTERS + ("sim_time_s", "final_val_error", "final_test_error",
                         "final_test_recall"):
        assert getattr(ev, k) == getattr(lp, k), k
    assert ev.val_error_curve == lp.val_error_curve
