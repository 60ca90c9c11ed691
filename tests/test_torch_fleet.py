"""The port's vectorized fleet profile against the JAX package's, on the CPU.

* Threshold grids (``stump_thresholds_batched``) bit-equal to the
  reference's on ragged fleet stacks.
* Batched picks (``fit_stump_batched``) equal to the reference's wherever
  the best two stumps' errors are further apart than f32 summation can move
  them, and to the first index at exact ties.
* Whole runs: the reference's own fleet test (8 clients, ``catch_up_cap=4``,
  ``i_init=2``) and ``mobile_100k`` cut to 512 clients on its 4-row shards.
  Baseline accounting does not depend on what is learned, so the port's own
  run gives every counter and ``sim_time_s`` exactly.  Enhanced runs are held
  in lockstep: the port's fleet is handed the reference's (feature,
  threshold, polarity) at every wave, after checking that the wave's inputs
  are the reference's; then every counter, the clock and the errors are
  exact and the margins agree to 1e-5.  The port's own pick on each wave's
  inputs is the reference's, or ties it to within f32 rounding.
* The port's fleet and its per-client engine give the same accounting.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.configs import paper_fedboost as jconf  # noqa: E402
from repro.core import FederatedBoostEngine as JaxEngine  # noqa: E402
from repro.core import fleet as jfleet  # noqa: E402
from repro.data import make_domain_data as jax_domain_data  # noqa: E402
from repro.models import weak as jweak  # noqa: E402
from repro.sim.scenarios import get_scenario as jax_scenario  # noqa: E402
from repro_torch.configs import paper_fedboost as tconf  # noqa: E402
from repro_torch.convert import domain_data_from_numpy  # noqa: E402
from repro_torch.core import FederatedBoostEngine  # noqa: E402
from repro_torch.models import weak  # noqa: E402
from repro_torch.sim.scenarios import get_scenario  # noqa: E402

INT_FIELDS = ("uplink_bytes", "downlink_bytes", "n_messages", "n_syncs",
              "learners_merged", "rounds_unavailable")
# two stumps whose errors lie this close may be ordered either way by an
# f32 sum over a shard of a few hundred rows
ROUNDING = 1e-6


def stack(shards):
    """Pad client shards to the longest and stack them, as both fleets do:
    (X (B,N,F), n_valid (B,))."""
    n_valid = np.array([len(x) for x, _ in shards], np.int32)
    B, N, F = len(shards), int(n_valid.max()), shards[0][0].shape[1]
    X = np.zeros((B, N, F), np.float32)
    for b, (x, _) in enumerate(shards):
        X[b, :len(x)] = x
    return X, n_valid


def cut_fleet(sc, n_clients):
    """``mobile_100k`` (either package's) cut to ``n_clients`` clients on
    its 4-row shards: 4 samples a client, as at full size."""
    return dataclasses.replace(sc, domain=dataclasses.replace(
        sc.domain, n_clients=n_clients, n_samples=4 * n_clients))


def small_fleet_shards(n_clients):
    return cut_fleet(jax_scenario("mobile_100k"), n_clients).make_data(0)


def grid_case(name):
    """A padded fleet stack (X (B,N,F), n_valid (B,)) for a grid test."""
    if name == "F=1":
        rng = np.random.RandomState(0)
        x = rng.randn(40, 9, 1).astype(np.float32)
        return x, rng.randint(1, 10, size=40).astype(np.int32)
    if name == "fleet":                       # 3- and 4-row shards, F = 48
        return stack(small_fleet_shards(512)["clients"])
    dom = get_scenario("edge_vision").domain  # dirichlet: up to ~600 rows
    return stack(jax_domain_data(dom, seed=1)["clients"])


@pytest.mark.parametrize("name", ["F=1", "fleet", "dirichlet"])
def test_threshold_grids_bit_equal_reference(name):
    X, n_valid = grid_case(name)
    want = np.asarray(jweak.stump_thresholds_batched(jnp.asarray(X),
                                                     jnp.asarray(n_valid)))
    got = weak.stump_thresholds_batched(torch.from_numpy(X),
                                        torch.from_numpy(n_valid))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _picks(p):
    return list(zip(np.asarray(p["feature"]).tolist(),
                    np.asarray(p["threshold"]).tolist(),
                    np.asarray(p["polarity"]).tolist()))


def _errs(x, y, w, thr):
    """Both polarities' errors per slot, summed in f64: (B, 2*F*T)."""
    miss = np.where(x[:, :, :, None] > thr[:, None], 1.0, -1.0) != y[
        :, :, None, None]
    e = np.einsum("bn,bnft->bft", w.astype(np.float64), miss)
    e = e.reshape(len(x), -1)
    return np.concatenate([e, 1.0 - e], axis=1)


def _pick_err(errs, thr, pick):
    """Slot errors ``errs`` (2*F*T,) of both polarities at a pick."""
    f, th, pol = pick
    F, T = thr.shape
    t = int(np.nonzero(thr[f] == th)[0][0])
    return errs[f * T + t + (0 if pol > 0 else F * T)]


@pytest.mark.parametrize("N,uniform", [(37, False), (4, True)])
def test_batched_picks_match_reference(N, uniform):
    rng = np.random.RandomState(N)
    B, F = 64, 12
    x = rng.randn(B, N, F).astype(np.float32)
    x[:, :, ::4] = np.round(x[:, :, ::4])          # repeated values: ties
    y = np.where(rng.rand(B, N) < 0.5, 1.0, -1.0).astype(np.float32)
    # uniform 1/4 weights sum exactly in f32, so exact ties stay ties in
    # the reference too and both must take the first index
    w = (np.full((B, N), 1.0 / N, np.float32) if uniform
         else rng.rand(B, N).astype(np.float32))
    thr = np.array(jweak.stump_thresholds_batched(
        jnp.asarray(x), jnp.full(B, N, jnp.int32)))
    want = _picks(jweak.fit_stump_batched(*map(jnp.asarray, (x, y, w, thr))))
    got = _picks(weak.fit_stump_batched(*(torch.from_numpy(a)
                                          for a in (x, y, w, thr))))
    errs = _errs(x, y, w, thr)
    ties = 0
    for b in range(B):
        if got[b] == want[b]:
            continue
        assert not uniform, (b, got[b], want[b])
        # an f32 sum may order two stumps that err alike either way
        gap = (_pick_err(errs[b], thr[b], want[b])
               - _pick_err(errs[b], thr[b], got[b]))
        assert abs(gap) <= ROUNDING, (b, got[b], want[b], gap)
        ties += 1
    assert ties <= B // 8


def test_batched_pick_takes_first_index_and_plus_on_equality():
    err = torch.tensor([[[0.5, 0.25, 0.25], [0.75, 0.5, 0.25]],
                        [[0.5, 0.5, 0.5], [0.5, 0.5, 0.5]],
                        [[0.4, 0.9, 0.5], [0.6, 0.5, 0.5]]])
    thr = torch.arange(18, dtype=torch.float32).reshape(3, 2, 3)
    p = weak._pick_stump_batched(err, thr)
    # slot 0: +1 at (0, 1), the first 0.25; -1 at (1, 0) errs 0.25 too
    # slot 1: a tie everywhere: cell 0 with polarity +1
    # slot 2: -1 at (0, 1) errs 0.1 < 0.4
    assert p["feature"].tolist() == [0, 0, 0]
    assert p["threshold"].tolist() == [1.0, 6.0, 13.0]
    assert p["polarity"].tolist() == [1.0, 1.0, -1.0]


# ------------------------------------------------------------- whole runs
def _fleet_test_config():
    """The JAX package's own fleet test (tests/test_engine_parity.py)."""
    dom = jconf.DomainConfig(
        name="mobile", n_samples=1200, n_features=12, n_clients=8,
        noniid_alpha=0.5, label_imbalance=0.5, noise=0.15,
        straggler_factor=4.0, dropout_prob=0.2, link_mbps=5.0)
    data = jax_domain_data(dom, seed=0, partitioner="iid")
    kw = dict(n_clients=8, n_rounds=6, straggler_factor=4.0,
              dropout_prob=0.2, link_mbps=5.0, seed=3, catch_up_cap=4)
    return (data, jconf.FedBoostConfig(
                scheduler=jconf.SchedulerConfig(i_init=2), **kw),
            tconf.FedBoostConfig(
                scheduler=tconf.SchedulerConfig(i_init=2), **kw))


def _mobile_512_config():
    """``mobile_100k``'s configuration cut to 512 clients, 4-row shards."""
    jsc = cut_fleet(jax_scenario("mobile_100k"), 512)
    tsc = cut_fleet(get_scenario("mobile_100k"), 512)
    return (jsc.make_data(0), jsc.fedboost_config(seed=0),
            tsc.fedboost_config(seed=0))


CONFIGS = {"fleet_test": _fleet_test_config, "mobile_512": _mobile_512_config}


class WaveLog:
    """Records the reference fleet's waves: inputs and picks."""

    def __init__(self, monkeypatch):
        self.waves = []
        orig = jfleet.FleetCore._fit_wave

        def fit_wave(core, slots):
            f, thr, pol = orig(core, slots)
            self.waves.append(dict(
                slots=np.array(slots), x=core.X[slots].copy(),
                y=core.Y[slots].copy(), w=core.D[slots].copy(),
                thr=core.THR[slots].copy(), f=np.array(f), t=np.array(thr),
                p=np.array(pol)))
            return f, thr, pol
        monkeypatch.setattr(jfleet.FleetCore, "_fit_wave", fit_wave)


def lockstep_spec(waves, own_picks):
    """A stump spec whose batched fit checks each wave's inputs against the
    reference's, records the port's own pick on the reference's inputs,
    and returns the reference's pick."""
    base = weak.get_weak_learner("stump")
    replay = iter(waves)

    def fit_batched(x, y, w, thr):
        r = next(replay)
        i = len(own_picks)
        assert np.array_equal(x.numpy(), r["x"]), f"wave {i}: shards"
        assert np.array_equal(y.numpy(), r["y"]), f"wave {i}: labels"
        assert np.array_equal(thr.numpy(), r["thr"]), f"wave {i}: grids"
        np.testing.assert_allclose(w.numpy(), r["w"], rtol=1e-4, atol=1e-9,
                                   err_msg=f"wave {i}: distributions")
        mine = weak.fit_stump_batched(*(torch.from_numpy(r[k])
                                        for k in ("x", "y", "w", "thr")))
        own_picks.append((r, _picks(mine)))
        return {"feature": torch.from_numpy(r["f"].astype(np.int32)),
                "threshold": torch.from_numpy(r["t"]),
                "polarity": torch.from_numpy(r["p"])}
    return dataclasses.replace(base, fit_batched=fit_batched)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def config(request):
    return request.param, CONFIGS[request.param]()


@pytest.mark.parametrize("mode", ["baseline", "enhanced"])
def test_fleet_matches_reference(config, mode, monkeypatch):
    name, (jdata, jcfg, tcfg) = config
    log = WaveLog(monkeypatch)
    jeng = JaxEngine(jcfg, jdata, mode, fleet=True)
    jm = jeng.run()
    assert log.waves
    data = domain_data_from_numpy(jdata["clients"], jdata["val"],
                                  jdata["test"])
    own = FederatedBoostEngine(tcfg, data, mode, fleet=True,
                               device="cpu").run()
    picks = []
    leng = FederatedBoostEngine(tcfg, data, mode, fleet=True, device="cpu",
                                weak=lockstep_spec(log.waves, picks))
    lm = leng.run()
    assert len(picks) == len(log.waves)
    runs = {"lockstep": lm}
    if mode == "baseline":
        # a synchronous round's accounting does not depend on what is learned
        runs["own"] = own
    for kind, m in runs.items():
        diff = {k: (getattr(jm, k), getattr(m, k)) for k in INT_FIELDS
                if getattr(jm, k) != getattr(m, k)}
        assert not diff, f"{name} {mode} {kind}: reference vs port {diff}"
        assert m.sim_time_s == jm.sim_time_s, (kind, m.sim_time_s)
    assert lm.final_val_error == jm.final_val_error
    assert lm.final_test_error == jm.final_test_error
    assert len(lm.val_error_curve) == len(jm.val_error_curve)
    for a, b in zip(jm.val_error_curve, lm.val_error_curve):
        assert a == b
    for mine, ref_m in ((leng._val_margin, jeng._val_margin),
                        (leng._test_margin, jeng._test_margin)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref_m),
                                   rtol=1e-5, atol=1e-5)
    # the port's own pick on every wave's inputs: the reference's, or a tie
    ties = 0
    for r, mine in picks:
        errs = _errs(r["x"], r["y"], r["w"], r["thr"])
        want = _picks(dict(feature=r["f"], threshold=r["t"],
                           polarity=r["p"]))
        for j, (got, ref_pick) in enumerate(zip(mine, want)):
            if got == ref_pick:
                continue
            gap = (_pick_err(errs[j], r["thr"][j], ref_pick)
                   - _pick_err(errs[j], r["thr"][j], got))
            assert abs(gap) <= ROUNDING, (name, mode, j, got, ref_pick, gap)
            ties += 1
    print(f"{name} {mode}: own counters "
          f"{ {k: getattr(own, k) for k in INT_FIELDS} }, sim_time_s "
          f"{own.sim_time_s!r}; reference {jm.sim_time_s!r}; {ties} "
          f"rounding ties among {sum(len(m) for _, m in picks)} picks")


@pytest.mark.parametrize("mode", ["baseline", "enhanced"])
def test_fleet_matches_port_engine_accounting(mode):
    jdata, _, tcfg = _fleet_test_config()
    data = domain_data_from_numpy(jdata["clients"], jdata["val"],
                                  jdata["test"])
    per = FederatedBoostEngine(tcfg, data, mode, fleet=False,
                               device="cpu").run()
    flt = FederatedBoostEngine(tcfg, data, mode, fleet=True,
                               device="cpu").run()
    for f in INT_FIELDS:
        assert getattr(per, f) == getattr(flt, f), f
    assert per.sim_time_s == flt.sim_time_s
    assert len(per.val_error_curve) == len(flt.val_error_curve)
    assert abs(per.final_val_error - flt.final_val_error) < 0.05
    assert abs(per.final_test_error - flt.final_test_error) < 0.05


def test_fleet_auto_selection_threshold():
    x = np.zeros((1, 2), np.float32)
    y = np.ones(1, np.float32)
    cfg = tconf.FedBoostConfig(n_clients=1, n_rounds=1)
    n = FederatedBoostEngine.FLEET_AUTO_CLIENTS
    assert n == 4096
    for clients, want in ((n - 1, False), (n, True)):
        data = {"clients": [(x, y)] * clients, "val": (x, y),
                "test": (x, y)}
        eng = FederatedBoostEngine(cfg, data, "baseline", engine="loop",
                                   device="cpu")
        assert eng.fleet_profile is want
        assert eng.engine_kind == ("events" if want else "loop")
        if want:
            # no per-client device copy: the shards stay as they came
            assert eng.clients[0].D is None and eng.clients[0].x is x


def test_fleet_refuses_a_learner_without_a_batched_fit():
    jdata, _, tcfg = _fleet_test_config()
    data = domain_data_from_numpy(jdata["clients"], jdata["val"],
                                  jdata["test"])
    base = weak.get_weak_learner("stump")
    spec = weak.WeakLearnerSpec("logistic", base.fit, base.predict,
                                base.param_bytes)
    eng = FederatedBoostEngine(tcfg, data, "baseline", fleet=True,
                               weak=spec, device="cpu")
    with pytest.raises(ValueError, match="stump"):
        eng.run()
