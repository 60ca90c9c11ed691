"""The spans and counters inside ``fed_mesh``'s step and the dispatcher, on
the CPU: their nesting, the slot counters against the benchmark's
``sync_slot_use``, the states bit-equal with recording off, on and under
``torch.profiler`` alone, and the profiled tracer."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.configs.paper_fedboost import (  # noqa: E402
    FedBoostConfig, SchedulerConfig)
from repro_torch.core import fed_mesh  # noqa: E402
from repro_torch.kernels.dispatch import KernelPolicy  # noqa: E402
from repro_torch.models.weak import stump_thresholds  # noqa: E402
from repro_torch.obs import trace  # noqa: E402

K, N, NV, F, ROUNDS, CAP = 4, 48, 20, 5, 14, 4
SYNC_PARTS = ["collect", "gather", "alpha", "fold", "gather", "foreign",
              "margin", "read_back", "interval"]


def _problem(seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(F)
    x = rng.randn(K, N, F).astype(np.float32)
    xv = rng.randn(K, NV, F).astype(np.float32)
    noisy = lambda a: np.where(a @ w + 0.5 * rng.randn(*a.shape[:2]) > 0,
                               1.0, -1.0).astype(np.float32)
    x, y, xv, yv = (torch.from_numpy(a) for a in (x, noisy(x), xv,
                                                   noisy(xv)))
    return x, y, xv, yv, stump_thresholds(x.reshape(-1, F), 8)


def _federation(i_max=CAP, rounds=ROUNDS, seed=0):
    """Every state of one federation, before round 0 and after each
    round, and the (synced, n_buf) of each step as the benchmark keeps
    them."""
    x, y, xv, yv, thr = _problem(seed)
    cfg = FedBoostConfig(n_clients=K, n_rounds=rounds,
                         scheduler=SchedulerConfig(i_min=1, i_max=i_max,
                                                   i_init=1))
    step = fed_mesh.make_fed_boost_step(cfg, thr,
                                        policy=KernelPolicy(env_var=None))
    states = [fed_mesh.init_state(cfg, K, N, NV, CAP, K * rounds,
                                  device="cpu")]
    took = []
    for _ in range(rounds):
        s = states[-1]
        new = step(s, x, y, xv, yv)
        synced = new.sync_count != s.sync_count
        took.append((synced, min(new.counter - s.last_sync, CAP)
                     if synced else 0))
        states.append(new)
    return states, took


def _by_parent(spans):
    out = {}
    for d in spans:
        out.setdefault(d["parent"], []).append(d)
    for kids in out.values():
        kids.sort(key=lambda d: d["t0"])
    return out


def _leaves(state):
    return [v if isinstance(v, torch.Tensor) else torch.tensor(v)
            for v in state]


def test_one_federation_nests_its_spans():
    with obs.tracing() as tr:
        states, took = _federation()
    spans = tr.finished()
    kids = _by_parent(spans)
    steps = [d for d in spans if d["name"] == "fed_mesh.step"]
    assert [d["attrs"]["round"] for d in steps] == list(range(ROUNDS))
    assert [d["attrs"]["synced"] for d in steps] == [s for s, _ in took]
    assert all(d["parent"] is None for d in steps)
    assert [d["name"] for d in spans if d["parent"] is None].count(
        "fed_mesh.init") == 1
    syncs = 0
    for st, (synced, n_buf) in zip(steps, took):
        names = [d["name"] for d in kids[st["span"]]]
        assert names == ["fed_mesh.round"] + ["fed_mesh.sync"] * synced
        rnd = kids[st["span"]][0]
        assert [d["name"] for d in kids[rnd["span"]]] == \
            ["fed_mesh.fit", "fed_mesh.update"]
        if not synced:
            continue
        syncs += 1
        sy = kids[st["span"]][1]
        assert sy["attrs"] == {"n_buf": n_buf, "slots": K * CAP}
        parts = kids[sy["span"]]
        assert [d["name"] for d in parts] == \
            [f"fed_mesh.sync.{p}" for p in SYNC_PARTS]
        assert [d["attrs"].get("rows") for d in parts
                if d["name"].endswith("gather")] == [NV, N]
        for d in parts:
            assert sy["t0"] <= d["t0"] <= d["t1"] <= sy["t1"]
    assert syncs == states[-1].sync_count > 2
    # the kernel spans: the scan under each fit, a vote under each
    # foreign update and each validation margin, nothing elsewhere
    names = {d["span"]: d["name"] for d in spans}
    under = [names[d["parent"]] for d in spans
             if d["name"].startswith("kernel.")]
    assert sorted(set(under)) == ["fed_mesh.fit", "fed_mesh.sync.foreign",
                                  "fed_mesh.sync.margin"]
    assert under.count("fed_mesh.fit") == ROUNDS
    assert under.count("fed_mesh.sync.foreign") == syncs
    assert {d["name"] for d in spans if d["name"].startswith("kernel.")} \
        == {"kernel.stump_scan_batched", "kernel.stump_vote_batched"}


@pytest.mark.parametrize("i_max", [1, CAP])
def test_slot_counters_give_the_benchmarks_sync_slot_use(i_max):
    """``slots_used / slots_voted`` is the benchmark's ``sync_slot_use``
    (its formula over the same steps), and they are the step's only
    counters."""
    with obs.tracing():
        _, took = _federation(i_max=i_max)
        c = {name: ctr.value for name, _, ctr in obs.get_registry().counters()
             if name.startswith("fed_mesh.")}
    n_bufs = [n for s, n in took if s]
    formula = 100.0 * K * sum(n_bufs) / (K * CAP * len(n_bufs))
    assert 100.0 * c["fed_mesh.slots_used"] / c["fed_mesh.slots_voted"] \
        == pytest.approx(formula, rel=1e-12)
    assert c["fed_mesh.slots_voted"] == len(n_bufs) * K * CAP
    assert sorted(c) == ["fed_mesh.slots_used", "fed_mesh.slots_voted"]


def test_states_are_bit_equal_off_traced_and_profiled():
    obs.disable()
    off, _ = _federation()
    with obs.tracing():
        traced, _ = _federation()
    with profile(activities=[ProfilerActivity.CPU]):
        profiled, _ = _federation()
    for a, b, c in zip(off, traced, profiled):
        for u, v, w in zip(_leaves(a), _leaves(b), _leaves(c)):
            assert torch.equal(u, v) and torch.equal(u, w)


def test_profiler_alone_fills_the_profiled_tracer_and_its_timeline():
    obs.disable()
    if obs.profiled_tracer() is not None:
        obs.profiled_tracer().clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert obs.active()
        _federation(rounds=5)
    assert not obs.active()
    spans = obs.profiled_tracer().finished()
    names = sorted(d["name"] for d in spans)
    assert "fed_mesh.sync.read_back" in names
    assert "kernel.stump_scan_batched" in names
    # each span is a CPU range of its own name on the profiler's timeline
    ranges = sorted(e.name for e in prof.events()
                    if e.name.startswith(("fed_mesh.", "kernel.")))
    assert ranges == names
    # nothing more lands there once the profiler has stopped
    _federation(rounds=2)
    assert len(obs.profiled_tracer()) == len(spans)


def test_spans_are_the_shared_no_op_with_neither_on():
    obs.disable()
    assert not obs.active()
    assert obs.span("fed_mesh.step", device=True) is obs.NULL_SPAN
    assert obs.point("fed_mesh.step") is obs.NULL_SPAN
    with obs.tracing():
        assert obs.active()
        assert obs.span("x") is not obs.NULL_SPAN
    assert not obs.active()


class _SlowEvent:
    """A CUDA event whose record takes ``LAG`` seconds of host time; counts
    how many were made."""
    LAG = 2e-3
    made = 0

    def __init__(self, enable_timing=False):
        _SlowEvent.made += 1
        self.t = None

    def record(self, stream=None):
        import time
        self.t = time.perf_counter()
        while time.perf_counter() < self.t + self.LAG:
            pass

    def query(self):
        return True

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_host_times_leave_out_the_recording(monkeypatch):
    """A span's ``t0``..``t1`` leaves out its own events, and ``rec_s``
    holds its descendants' recording, so ``t1 - t0 - rec_s`` is the
    host's own work; the spans still nest, and a resolved span's events
    serve the next device span."""
    monkeypatch.setattr(torch.cuda, "Event", _SlowEvent)
    monkeypatch.setattr(trace, "_current_stream", lambda: None)
    monkeypatch.setattr(_SlowEvent, "made", 0)
    lag = _SlowEvent.LAG
    with obs.tracing() as tr:
        with obs.span("outer"):
            for _ in range(2):
                with obs.span("inner", device=True):
                    pass
        obs.resolve()
        with obs.span("again", device=True):
            pass
        obs.resolve()
    d = tr.finished()
    outer, inner = d[2], d[0]
    assert [s["name"] for s in d] == ["inner", "inner", "outer", "again"]
    assert inner["t1"] - inner["t0"] < lag / 2
    assert "rec_s" not in inner
    assert outer["t1"] - outer["t0"] > 4 * lag
    assert 4 * lag <= outer["rec_s"] < outer["t1"] - outer["t0"]
    assert outer["t1"] - outer["t0"] - outer["rec_s"] < lag / 2
    assert outer["t0"] <= inner["t0"] <= inner["t1"] <= d[1]["t0"] \
        <= d[1]["t1"] <= outer["t1"]
    assert inner["attrs"]["device_ms"] >= lag * 1e3
    assert _SlowEvent.made == 4                 # "again" took two back
