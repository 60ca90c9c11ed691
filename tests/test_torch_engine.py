"""The port's federated boosting engine against the JAX package's, as it
ships.

Edge_vision at full size, seed 0, 25 rounds, both modes, on the CPU.  One
reference run per mode (its own stump learner, recorded through the
``weak=`` hook without changing what it does) faces three port runs:

* lockstep: the port's engine handed the reference's stump at every fit,
  after checking that the fit's inputs are the reference's (x and y equal,
  the distribution within 1e-4 relative: the two libraries' ``exp`` and
  ``log`` differ in the last bits).  Scheduling, compensation, the
  distribution update, the accounting and the event clock are the port's
  own, and must give every counter of the reference exactly (ROADMAP A3),
  its ``sim_time_s`` within 1e-9 and its errors to one sample.  At each of
  those fits the port's own learner also picks on the reference's inputs:
  the reference's stump, or one whose exact error is within rounding of it.
* own, on the events and the loop engine: the port alone.  Baseline
  counters do not depend on what is learned and equal the reference's.
  Enhanced ones follow the validation error: where they differ, the two
  runs split at a fit whose two picks err alike to within 1e-6 in exact
  arithmetic on the same inputs; the test prints that fit and its gap.

The reference sums stump errors in f32 and settles exact ties by that
sum's rounding; the port sums in f64 and settles them by index (ROADMAP
C4), so the picks may differ at exact ties and nowhere else.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.paper_fedboost import (  # noqa: E402
    FedBoostConfig as JaxConfig)
from repro.core import FederatedBoostEngine as JaxEngine  # noqa: E402
from repro.data import make_domain_data as jax_domain_data  # noqa: E402
from repro.models import weak as jweak  # noqa: E402
from repro.sim.scenarios import DOMAINS  # noqa: E402
from repro_torch.configs.paper_fedboost import FedBoostConfig  # noqa: E402
from repro_torch.convert import domain_data_from_numpy  # noqa: E402
from repro_torch.core import FederatedBoostEngine  # noqa: E402
from repro_torch.models import weak  # noqa: E402

COUNTERS = ("uplink_bytes", "downlink_bytes", "n_messages", "n_syncs",
            "learners_merged", "snapshots_published", "rounds_unavailable")
# the reference's runs of this fixture as it ships (ROADMAP A3)
TABLE = {"baseline": dict(total_bytes=217_824, n_messages=600, n_syncs=25,
                          learners_merged=300, sim_time_s=118.69),
         "enhanced": dict(total_bytes=86_304, n_messages=126, n_syncs=63,
                          learners_merged=300, sim_time_s=132.10)}
# two picks whose exact errors are this close are a tie up to rounding:
# an f32 sum over a client shard moves an error by well under it
ROUNDING = 1e-6
# an f64 sum rounded once to f32, then 1 - err for polarity -1: two f32
# steps at 1.0, the largest an error can be
F32_STEPS = 2 * float(np.spacing(np.float32(1.0)))


def _key(p):
    return (int(p["feature"]), float(p["threshold"]), float(p["polarity"]))


def _exact_err(fit, key):
    """The weighted error of stump ``key`` on a recorded fit's inputs,
    summed in f64, and the least such error over the fit's grid."""
    x, y, w, thr = (np.asarray(a, np.float64) for a in fit)
    miss = (np.where(x[:, :, None] > thr[None], 1.0, -1.0)
            != y[:, None, None])
    err = np.einsum("n,nft->ft", w, miss)
    f, th, pol = key
    t = int(np.nonzero(thr[f] == th)[0][0])
    mine = err[f, t] if pol > 0 else 1.0 - err[f, t]
    return mine, min(err.min(), 1.0 - err.max())


def _tie(i, fit, ref_key, port_key):
    """Fit #i, whose picks differ: the gap between the two picks' exact
    errors on the fit's inputs, a line that shows the fit, and how far the
    port's pick lies above the least exact error."""
    e_ref, least = _exact_err(fit, ref_key)
    e_port, _ = _exact_err(fit, port_key)
    return e_ref - e_port, (
        f"fit #{i}: reference {ref_key} vs port {port_key}; exact errors "
        f"{e_ref:.10g} vs {e_port:.10g} (gap {e_ref - e_port:.3g}, least "
        f"{least:.10g})"), e_port - least


def _run_pair(mode):
    dom = DOMAINS["edge_vision"]
    jdata = jax_domain_data(dom, seed=0)
    kw = dict(n_clients=dom.n_clients, n_rounds=25,
              straggler_factor=dom.straggler_factor,
              dropout_prob=dom.dropout_prob, link_mbps=dom.link_mbps)
    jbase = jweak.get_weak_learner("stump")
    jfits = []                        # (x, y, w, thresholds), pick key

    def jfit(x, y, w, key):
        p = jbase.fit(x, y, w, key)
        jfits.append(((np.asarray(x), np.asarray(y), np.asarray(w),
                       np.asarray(jweak.stump_thresholds(x))), _key(p)))
        return p
    jspec = jweak.WeakLearnerSpec("stump", jfit, jbase.predict,
                                  jbase.param_bytes)
    jm = JaxEngine(JaxConfig(**kw), jdata, mode, weak=jspec).run()

    data = domain_data_from_numpy(jdata["clients"], jdata["val"],
                                  jdata["test"])
    base = weak.get_weak_learner("stump")
    cfg = FedBoostConfig(**kw)

    # lockstep: the reference's stump at every fit, the port's own pick on
    # the same inputs beside it
    replay = iter(jfits)
    lock_picks = []

    def lockstep_fit(x, y, w, generator=None):
        (jx, jy, jw, _), ref_key = next(replay)
        i = len(lock_picks)
        same = np.array_equal(x.numpy(), jx) and np.array_equal(y.numpy(), jy)
        assert same, f"{mode}: fit #{i} is on another shard than the ref's"
        np.testing.assert_allclose(w.numpy(), jw, rtol=1e-4, atol=1e-9,
                                   err_msg=f"{mode}: distribution at fit #{i}")
        mine = base.fit(*(torch.tensor(a) for a in (jx, jy, jw)))
        lock_picks.append(_key(mine))
        f, th, pol = ref_key
        return {"feature": torch.tensor(f, dtype=torch.int32),
                "threshold": torch.tensor(th, dtype=torch.float32),
                "polarity": torch.tensor(pol, dtype=torch.float32)}
    lspec = weak.WeakLearnerSpec("stump", lockstep_fit, base.predict,
                                 base.param_bytes)
    lock = FederatedBoostEngine(cfg, data, mode, weak=lspec,
                                device="cpu").run()
    assert len(lock_picks) == len(jfits)

    own, own_picks = {}, {}
    for kind in ("events", "loop"):
        picks = own_picks[kind] = []

        def own_fit(x, y, w, generator=None, picks=picks):
            p = base.fit(x, y, w, generator)
            picks.append(_key(p))
            return p
        ospec = weak.WeakLearnerSpec("stump", own_fit, base.predict,
                                     base.param_bytes)
        own[kind] = FederatedBoostEngine(cfg, data, mode, weak=ospec,
                                         engine=kind, device="cpu").run()
    return dict(ref=jm, fits=jfits, lock=lock, lock_picks=lock_picks,
                own=own, own_picks=own_picks["events"])


@pytest.fixture(scope="module", params=["baseline", "enhanced"])
def pair(request):
    return request.param, _run_pair(request.param)


def test_counters_equal_reference(pair):
    mode, r = pair
    jm, pm = r["ref"], r["lock"]
    diff = {k: (getattr(jm, k), getattr(pm, k)) for k in COUNTERS
            if getattr(jm, k) != getattr(pm, k)}
    assert not diff, f"{mode}: reference vs port {diff}"
    assert abs(pm.sim_time_s - jm.sim_time_s) <= 1e-9, (
        mode, pm.sim_time_s, jm.sim_time_s)


def test_errors_within_one_sample_of_reference(pair):
    mode, r = pair
    jm, pm = r["ref"], r["lock"]
    one = 1.0 / 600 + 1e-6                   # val and test hold 600 rows
    assert abs(pm.final_test_error - jm.final_test_error) <= one, mode
    assert abs(pm.final_val_error - jm.final_val_error) <= one, mode
    assert len(pm.val_error_curve) == len(jm.val_error_curve)
    for (ta, na, ea), (tb, nb, eb) in zip(jm.val_error_curve,
                                         pm.val_error_curve):
        assert na == nb and abs(ta - tb) <= 1e-9 and abs(ea - eb) <= one


def test_port_picks_match_reference_at_every_fit(pair):
    """On the reference's own inputs, fit by fit: the port's stump is the
    reference's, or both err alike to within rounding and the port's is
    the least in exact arithmetic."""
    mode, r = pair
    ties = []
    for i, ((fit, ref_key), port_key) in enumerate(zip(r["fits"],
                                                       r["lock_picks"])):
        if ref_key == port_key:
            continue
        gap, what, above_least = _tie(i, fit, ref_key, port_key)
        assert abs(gap) <= ROUNDING, f"{mode}: {what}"
        assert above_least <= F32_STEPS, f"{mode}: {what}"
        ties.append(what)
    print(f"{mode}: {len(ties)} of {len(r['fits'])} picks differ, each at a "
          f"rounding tie" + "".join(f"\n  {t}" for t in ties))


def test_own_run_equals_reference_or_splits_at_a_rounding_tie(pair):
    mode, r = pair
    jm, pm = r["ref"], r["own"]["events"]
    diff = {k: (getattr(jm, k), getattr(pm, k)) for k in COUNTERS
            if getattr(jm, k) != getattr(pm, k)}
    if abs(pm.sim_time_s - jm.sim_time_s) > 1e-9:
        diff["sim_time_s"] = (jm.sim_time_s, pm.sim_time_s)
    if mode == "baseline":
        # a synchronous round's accounting does not depend on what is learned
        assert not diff, f"{mode}: reference vs port {diff}"
        return
    if not diff:
        return
    first = next((i for i, ((_, a), b) in enumerate(zip(r["fits"],
                                                        r["own_picks"]))
                  if a != b), None)
    assert first is not None, f"{mode}: counters {diff} with equal picks"
    fit, ref_key = r["fits"][first]
    # the two runs agree up to this fit, so its inputs are the reference's
    # (up to the distribution's last bits)
    gap, what, above_least = _tie(first, fit, ref_key, r["own_picks"][first])
    print(f"{mode}: the port's own run splits from the reference at {what};"
          f" counters reference vs port {diff}")
    assert abs(gap) <= ROUNDING, f"{mode}: first split {what}"
    assert above_least <= F32_STEPS, f"{mode}: first split {what}"


def test_events_and_loop_engines_agree_bit_for_bit(pair):
    _, r = pair
    ev, lp = r["own"]["events"], r["own"]["loop"]
    for k in COUNTERS + ("sim_time_s", "final_val_error", "final_test_error",
                         "final_test_recall"):
        assert getattr(ev, k) == getattr(lp, k), k
    assert ev.val_error_curve == lp.val_error_curve


def test_counters_match_reference_table(pair):
    mode, r = pair
    for run in (r["ref"], r["lock"]):
        got = {k: getattr(run, k) for k in TABLE[mode]}
        got["sim_time_s"] = round(got["sim_time_s"], 2)
        assert got == TABLE[mode]


def test_engine_refuses_unported_profiles():
    """The fleet profile, which this test once saw refused, runs and gives
    the per-client profile's accounting (``tests/test_torch_fleet.py``
    holds it to the reference).  Contribution audits, once refused too,
    attach to the per-client profile and are refused on the fleet's, as in
    the reference (``tests/test_torch_slo_audit.py`` holds them to it)."""
    rng = np.random.RandomState(0)
    x = rng.randn(8, 3).astype(np.float32)
    y = np.where(rng.rand(8) < 0.5, 1.0, -1.0).astype(np.float32)
    data = {"clients": [(x, y)], "val": (x, y), "test": (x, y)}
    cfg = FedBoostConfig(n_clients=1, n_rounds=2)
    for mode in ("baseline", "enhanced"):
        fleet = FederatedBoostEngine(cfg, data, mode, fleet=True,
                                     device="cpu")
        assert fleet.fleet_profile
        fm = fleet.run()
        pm = FederatedBoostEngine(cfg, data, mode, device="cpu").run()
        for k in COUNTERS + ("sim_time_s",):
            assert getattr(fm, k) == getattr(pm, k), (mode, k)
    eng = FederatedBoostEngine(cfg, data, "enhanced", device="cpu")
    audit = eng.attach_audit()
    assert eng.run().learners_merged == audit.recorded > 0
    with pytest.raises(ValueError, match="fleet"):
        FederatedBoostEngine(cfg, data, "enhanced", fleet=True,
                             device="cpu").attach_audit()
