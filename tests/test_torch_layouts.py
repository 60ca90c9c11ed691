"""The dispatcher's layout autotune: the cuda backend's launch grids.

``LAYOUT_GRIDS`` lists, for each kernel, the launches a caller may ask
for in place of the launcher's own choice (``{}``), as knobs whose names
never meet the JAX package's block-shape kwargs.  On the CPU a counting
stub stands in for the ``cuda`` backend (set in ``dispatch.BACKENDS`` for
one test and taken out after it): ``calibrate_call`` sweeps it over the
grid and measures ``torch`` once; the table's layout reaches it below the
caller's explicit knobs; a JAX-written table's Pallas layouts never do; a
layout that mixes both kinds of key is refused.  Buckets are the JAX
package's, and every scan split of the grid gives the plain version's
bits in the kernel's order (``ref.scan_in_kernel_order``).  On the card
(``-m cuda``) every member of every grid is held to the plain version,
and a launch the launcher cannot run raises.
"""
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import dispatch, ops, ref  # noqa: E402
from repro_torch.kernels.dispatch import (  # noqa: E402
    CUDA_LAYOUT_KWARGS, LAYOUT_GRIDS, LAYOUT_KWARGS, CalEntry, KernelPolicy,
    bucket_of, layout_key)

SMS = 132                       # the H100 SXM's SM count


def scan_case(seed, N, F, T):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, F).astype(np.float32)
    y = np.where(rng.rand(N) < 0.4, 1.0, -1.0).astype(np.float32)
    w = rng.rand(N).astype(np.float32)
    w /= w.sum()
    # every threshold is one of its feature's data values (strict `>` edge)
    thr = x[rng.randint(0, N, size=(F, T)), np.arange(F)[:, None]]
    return x, y, w, np.ascontiguousarray(thr, np.float32)


def batched_scan_case(seed, B, N, F, T):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, N, F).astype(np.float32)
    y = np.where(rng.rand(B, N) < 0.4, 1.0, -1.0).astype(np.float32)
    w = rng.rand(B, N).astype(np.float32)
    w[:, 1::3] = 0.0                                # padding rows
    rows = rng.randint(0, N, size=(B, F, T))
    thr = np.take_along_axis(x.transpose(0, 2, 1), rows, axis=2)
    return x, y, w, np.ascontiguousarray(thr, np.float32)


def vote_case(seed, B, T, N):
    rng = np.random.RandomState(seed)
    xsel = rng.randn(B, T, N).astype(np.float32)
    thr = rng.randn(B, T).astype(np.float32)
    xsel[:, ::3, ::2] = thr[:, ::3, None]           # x == thr: sign tiebreak
    pol = np.where(rng.rand(B, T) < 0.5, 1.0, -1.0).astype(np.float32)
    alphas = rng.rand(B, T).astype(np.float32)
    alphas[:, -5:] = 0.0                            # the batch's T padding
    return xsel, thr, pol, alphas


def margins_case(seed, shape):
    rng = np.random.RandomState(seed)
    m = (rng.rand(*shape) * 2 - 1).astype(np.float32)
    return m, rng.rand(*shape[:-1]).astype(np.float32)


def dist_case(seed, N):
    rng = np.random.RandomState(seed)
    D = rng.rand(N).astype(np.float32)
    D /= D.sum()
    y = np.where(rng.rand(N) < 0.5, 1.0, -1.0).astype(np.float32)
    h = rng.uniform(-1, 1, N).astype(np.float32)
    h[::3] = np.sign(h[::3])
    return np.float32(0.7), D, y, h


def flash_case(seed, B, H, T, d):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(B, H, T, d).astype(np.float32) for _ in range(3))


# one small call a kernel (numpy), as the ops wrapper takes its tensors
CASES = {
    "stump_scan": lambda: scan_case(0, 333, 64, 16),
    "stump_scan_batched": lambda: batched_scan_case(1, 50, 40, 12, 16),
    "ensemble_vote": lambda: margins_case(2, (300, 1000)),
    "ensemble_vote_batched": lambda: margins_case(3, (2, 300, 64)),
    "stump_vote_batched": lambda: vote_case(4, 2, 300, 64),
    "stump_vote_fp_batched": lambda: vote_case(5, 3, 600, 1000),
    "dist_update": lambda: dist_case(6, 8192),
    "flash_attention": lambda: flash_case(7, 2, 4, 200, 64),
}


def tensors(arrays, device="cpu"):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 if isinstance(a, np.ndarray) else float(a) for a in arrays)


class CountingStub:
    """Stands in for the ``cuda`` backend on the CPU: records each run's
    kernel and knobs, and computes the plain version.  With ``fast`` (a
    layout) it computes nothing: that layout returns at once and every
    other one after 20 ms."""
    name = "cuda"

    def __init__(self, fast=None):
        self.calls = []
        self.fast = fast

    def available(self, device):
        return True

    def run(self, kernel, *args, **kwargs):
        knobs = {k: kwargs.pop(k) for k in list(kwargs)
                 if k in CUDA_LAYOUT_KWARGS}
        self.calls.append((kernel, knobs))
        if self.fast is not None:
            if knobs != self.fast:
                time.sleep(0.02)
            return None
        return dispatch._TORCH_IMPLS[kernel](*args, **kwargs)


@pytest.fixture
def stub(monkeypatch):
    """A counting stub set as ``BACKENDS["cuda"]`` for one test."""
    be = CountingStub()
    monkeypatch.setitem(dispatch.BACKENDS, "cuda", be)
    yield be


# ------------------------------------------------------------ the grids

def test_every_grid_starts_with_the_launchers_choice_and_names_knobs():
    assert set(LAYOUT_GRIDS) == set(dispatch.CUDA_IMPLS) == set(ops.LAUNCHES)
    assert not set(CUDA_LAYOUT_KWARGS) & set(LAYOUT_KWARGS)
    for kernel, grid in LAYOUT_GRIDS.items():
        assert grid[0] == {}, kernel
        assert 2 <= len(grid) <= 7, kernel
        assert len({layout_key(m) for m in grid}) == len(grid), kernel
        for member in grid[1:]:
            assert member and set(member) <= set(CUDA_LAYOUT_KWARGS)
            assert all(type(v) is int for v in member.values())
            assert dispatch.is_cuda_layout(member)


@pytest.mark.parametrize("kernel", sorted(CASES))
def test_bucket_equals_the_jax_packages(kernel):
    jdispatch = pytest.importorskip("repro.kernels.dispatch")
    arrays = CASES[kernel]()
    assert bucket_of(kernel, tensors(arrays)) == \
        jdispatch.bucket_of(kernel, arrays)


def test_cluster_route_applies_up_to_its_capacity():
    cap = 4 * ops.DIST_CLUSTER * ops.DIST_THREADS
    assert dispatch.layout_applies("dist_update", (cap,), {"cluster": 1})
    assert not dispatch.layout_applies("dist_update", (cap + 1024,),
                                       {"cluster": 1})
    assert dispatch.layout_applies("dist_update", (cap + 1024,),
                                   {"cluster": 0, "threads": 256})
    assert all(dispatch.layout_applies("ensemble_vote", (256, 8192), m)
               for m in LAYOUT_GRIDS["ensemble_vote"])


def test_dist_knobs_set_route_and_threads():
    assert ops.dist_split(8192, SMS) == ops.dist_split(8192, SMS, None, None)
    grid = ops.dist_split(8192, SMS, 0)
    assert not grid.cluster and grid.blocks * grid.tile * 4 >= 8192
    assert ops.dist_split(8192, SMS, 1, 1024).threads == 1024
    past = ops.dist_split(4 * ops.DIST_CLUSTER * ops.DIST_THREADS + 4, SMS, 1)
    assert past.cluster and past.tile > ops.DIST_THREADS   # the card refuses
    with pytest.raises(ValueError, match="cluster"):
        ops.dist_split(8192, SMS, 2)


def test_a_knob_equal_to_the_launchers_own_marker_is_refused():
    assert ops._knob("deep", None, -1) == -1
    assert ops._knob("deep", 0, -1) == 0
    with pytest.raises(ValueError, match="names no launch"):
        ops._knob("deep", -1, -1)
    with pytest.raises(ValueError, match="names no launch"):
        ops._knob("threads", 0, 0)


# --------------------------------------------------------- scan splits

@pytest.mark.parametrize("member", LAYOUT_GRIDS["stump_scan"],
                         ids=dispatch.layout_label)
@pytest.mark.parametrize("N", [333, 2400])
def test_every_grid_split_gives_the_plain_bits(N, member):
    """Each member's split of (N, 64, 16) on 132 SMs is one the launcher
    takes, and the kernel's order over it rounds to the plain version's
    bits."""
    x, y, w, thr = tensors(scan_case(N, N, 64, 16))
    split = ops.scan_layout_split(N, 64, 16, SMS, **member)
    kb = split.chunks // split.blocks
    assert kb * split.cols == ops.SCAN_THREADS
    assert split.chunks % split.blocks == 0
    assert split.rows * split.chunks >= N
    assert 1 <= split.blocks <= ops.SCAN_MAX_BLOCKS
    if "cols" in member:
        assert split.cols == member["cols"]
    if "blocks" in member:
        assert split.blocks == member["blocks"]
    got = ref.scan_in_kernel_order(x, y, w, thr, split)
    want = ref.stump_scan_ref(x, y, w, thr)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_scan_split_without_knobs_is_the_launchers_own():
    for N in (333, 2400, 24000):
        assert ops.scan_layout_split(N, 64, 16, SMS) == \
            ops.scan_split(N, 64, 16, SMS)
        assert ops.scan_layout_split(N, 64, 16, SMS, cols=8) == \
            ops.scan_candidate(N, 64, 16, SMS, 8)
    with pytest.raises(ValueError, match="cols"):
        ops.scan_layout_split(333, 64, 16, SMS, cols=0)


# ---------------------------------------------------------- calibration

def test_calibrate_call_sweeps_the_grid_and_measures_torch_once(stub):
    m, a = tensors(CASES["ensemble_vote"]())
    pol = KernelPolicy(env_var=None)
    bucket, samples = pol.calibrate_call("ensemble_vote", m, a, reps=1)
    grid = LAYOUT_GRIDS["ensemble_vote"]
    assert set(samples) == {("torch", ())} | {
        ("cuda", layout_key(g)) for g in grid}
    assert all(len(ts) == 1 for ts in samples.values())
    # every member's warm-up run, then a round of timed runs
    assert [knobs for _, knobs in stub.calls] == grid + grid
    best = min(samples, key=lambda k: float(np.median(samples[k])))
    assert pol.table[("ensemble_vote", bucket)] == CalEntry(*best)


@pytest.mark.parametrize("reps", [1, 3])
def test_calibrate_call_records_the_median_winner(monkeypatch, reps):
    fast = {"tile_c": 2, "deep": 1, "groups": 2}
    be = CountingStub(fast=fast)
    monkeypatch.setitem(dispatch.BACKENDS, "cuda", be)
    args = tensors(CASES["stump_vote_batched"]())
    pol = KernelPolicy(env_var=None)
    bucket, samples = pol.calibrate_call("stump_vote_batched", *args,
                                         reps=reps, backends=["cuda"])
    assert len(be.calls) == (1 + reps) * len(
        LAYOUT_GRIDS["stump_vote_batched"])
    assert pol.table[("stump_vote_batched", bucket)] == \
        CalEntry("cuda", layout_key(fast))


class ScriptedClock:
    """A host clock that a stub backend advances by scripted seconds a
    run: ``durations[layout_key]`` is the list of each run's time (the
    warm-up's first)."""

    def __init__(self, durations):
        self.now = 0.0
        self.left = {k: list(v) for k, v in durations.items()}

    def perf_counter(self):
        return self.now

    def run(self, knobs):
        self.now += self.left[layout_key(knobs)].pop(0)


@pytest.mark.parametrize("member_s,kept", [(0.010, True), (0.0005, False)])
def test_calibrate_call_keeps_the_launchers_own_within_its_spread(
        monkeypatch, member_s, kept):
    """``{}`` at 10, 14 and 12 ms (median 12, spread 4): a member at 10 ms
    beats its median by less than the spread and ``{}`` stays; one at
    0.5 ms wins."""
    grid = [{}, {"deep": 1}]
    clock = ScriptedClock({(): [0.0, 0.010, 0.014, 0.012],
                           (("deep", 1),): [0.0] + [member_s] * 3})
    be = CountingStub()
    be.run = lambda kernel, *a, **kw: clock.run(
        {k: v for k, v in kw.items() if k in CUDA_LAYOUT_KWARGS})
    monkeypatch.setitem(dispatch.BACKENDS, "cuda", be)
    monkeypatch.setattr(dispatch, "time", clock)
    m, a = tensors(CASES["ensemble_vote"]())
    pol = KernelPolicy(env_var=None)
    bucket, samples = pol.calibrate_call("ensemble_vote", m, a, reps=3,
                                         backends=["cuda"], layouts=grid)
    assert samples[("cuda", ())] == pytest.approx([0.010, 0.014, 0.012])
    want = () if kept else (("deep", 1),)
    assert pol.table[("ensemble_vote", bucket)] == CalEntry("cuda", want)


def test_calibrate_call_takes_part_of_the_grid_only(stub):
    m, a = tensors(CASES["ensemble_vote"]())
    pol = KernelPolicy(env_var=None)
    _, samples = pol.calibrate_call("ensemble_vote", m, a, reps=1,
                                    backends=["cuda"],
                                    layouts=[{"deep": 1}])
    assert set(samples) == {("cuda", (("deep", 1),))}
    with pytest.raises(ValueError, match="not in LAYOUT_GRIDS"):
        pol.calibrate_call("ensemble_vote", m, a, reps=1,
                           layouts=[{"deep": 1, "tile_c": 2}])
    with pytest.raises(ValueError, match="not in LAYOUT_GRIDS"):
        pol.calibrate_call("ensemble_vote", m, a, reps=1,
                           layouts=[{"block_t": 64}])


def test_calibrate_call_skips_a_member_that_cannot_run_the_bucket(
        stub, capsys):
    args = tensors(dist_case(8, 40000))
    pol = KernelPolicy(env_var=None)
    bucket, samples = pol.calibrate_call("dist_update", *args, reps=1,
                                         backends=["cuda"])
    assert bucket == (40960,)
    assert ("cuda", (("cluster", 1),)) not in samples
    assert len(samples) == len(LAYOUT_GRIDS["dist_update"]) - 1
    assert "cluster=1 skipped" in capsys.readouterr().out
    assert {"cluster": 1} not in [knobs for _, knobs in stub.calls]


# ------------------------------------------------------------- dispatch

def test_explicit_knobs_over_the_table_over_the_launchers_own(stub):
    xsel, thr, pol_, al = tensors(CASES["stump_vote_batched"]())
    args = (xsel, thr, pol_, al)
    bucket = bucket_of("stump_vote_batched", args)
    key = ("stump_vote_batched", bucket)
    untuned = KernelPolicy(env_var=None)
    ops.stump_vote_batched(*args, backend="cuda", policy=untuned)
    assert stub.calls[-1][1] == {} and untuned.cuda_layout_choices[key] == {}
    table = {"tile_c": 2, "deep": 1, "groups": 2}
    pol = KernelPolicy(table={key: ("cuda", table)}, env_var=None)
    want = ops.stump_vote_batched(*args, backend="torch", policy=pol)
    assert pol.cuda_layout_choices[key] == {}         # torch takes no knob
    got = ops.stump_vote_batched(*args, backend="cuda", policy=pol)
    assert stub.calls[-1][1] == table == pol.cuda_layout_choices[key]
    assert torch.equal(got, want)
    ops.stump_vote_batched(*args, backend="cuda", policy=pol, groups=1)
    assert stub.calls[-1][1] == dict(table, groups=1) == \
        pol.cuda_layout_choices[key]
    ops.stump_vote_batched(*args, backend="cuda", policy=untuned, deep=0)
    assert stub.calls[-1][1] == {"deep": 0}
    # the caller's knobs never reach torch: the call raises
    with pytest.raises(ValueError, match="resolves to the torch backend"):
        ops.stump_vote_batched(*args, backend="torch", policy=untuned,
                               deep=0)
    assert len(stub.calls) == 4


@pytest.mark.parametrize("how", ["backend", "env", "table", "cpu tensor"])
def test_knobs_on_a_call_resolved_to_torch_raise(monkeypatch, how):
    """Explicit knobs are never dropped in silence: wherever the call
    resolves to ``torch`` (a pinned backend, the env variable, a table's
    winner, or a CPU tensor with the real backends), it raises."""
    m, a = tensors(CASES["ensemble_vote"]())
    key = ("ensemble_vote", bucket_of("ensemble_vote", (m, a)))
    kw = {}
    if how == "cpu tensor":
        pol = KernelPolicy(env_var=None)
    else:
        be = CountingStub()
        monkeypatch.setitem(dispatch.BACKENDS, "cuda", be)
        if how == "backend":
            pol, kw = KernelPolicy(env_var=None), {"backend": "torch"}
        elif how == "env":
            monkeypatch.setenv("REPRO_TEST_LAYOUT_BACKEND", "torch")
            pol = KernelPolicy(env_var="REPRO_TEST_LAYOUT_BACKEND")
        else:
            pol = KernelPolicy(table={key: ("torch", {})}, env_var=None)
    with pytest.raises(ValueError, match="resolves to the torch backend"):
        ops.ensemble_vote(m, a, policy=pol, deep=0, **kw)
    assert pol.choices[key] == "torch"
    if how != "cpu tensor":
        assert be.calls == []
    # without knobs the same call runs the plain version
    torch.testing.assert_close(ops.ensemble_vote(m, a, policy=pol, **kw),
                               ref.ensemble_vote_ref(m, a))


def test_table_layout_only_for_its_backend_and_its_grid(stub):
    m, a = tensors(CASES["ensemble_vote_batched"]())
    bucket = bucket_of("ensemble_vote_batched", (m, a))
    key = ("ensemble_vote_batched", bucket)
    pol = KernelPolicy(table={key: ("torch", {"deep": 1})}, env_var=None)
    ops.ensemble_vote_batched(m, a, backend="cuda", policy=pol)
    assert stub.calls[-1][1] == {} and pol.cuda_layout_choices[key] == {}
    odd = KernelPolicy(table={key: ("cuda", {"deep": 1, "tile_c": 2})},
                       env_var=None)
    with pytest.warns(RuntimeWarning, match="not in LAYOUT_GRIDS"):
        ops.ensemble_vote_batched(m, a, backend="cuda", policy=odd)
    assert stub.calls[-1][1] == {} and odd.cuda_layout_choices[key] == {}
    pol.record("ensemble_vote_batched", bucket, "cuda", {"deep": 0})
    ops.ensemble_vote_batched(m, a, backend="cuda", policy=pol)
    assert stub.calls[-1][1] == {"deep": 0}


def test_jax_table_layouts_never_launch_port_table_knobs_do(stub, tmp_path):
    jdispatch = pytest.importorskip("repro.kernels.dispatch")
    m, a = tensors(CASES["ensemble_vote"]())
    bucket = bucket_of("ensemble_vote", (m, a))
    key = ("ensemble_vote", bucket)
    jpol = jdispatch.KernelPolicy()
    jpol.record("ensemble_vote", bucket, "mosaic",
                {"block_t": 64, "block_n": 256})
    path = jpol.save(str(tmp_path / "jax.json"), measured_on="cpu")
    pol = KernelPolicy.load(path)
    assert pol.table[key] == CalEntry(
        "cuda", (("block_n", 256), ("block_t", 64)))
    ops.ensemble_vote(m, a, backend="cuda", policy=pol)
    assert stub.calls[-1][1] == {} and pol.cuda_layout_choices[key] == {}
    assert pol.layout_choices[key] == {"block_t": 64, "block_n": 256}
    pol.save(str(tmp_path / "back.json"))
    assert KernelPolicy.load(str(tmp_path / "back.json")).table == pol.table
    # a table the port wrote: its knobs launch
    mine = KernelPolicy(env_var=None)
    mine.record("ensemble_vote", bucket, "cuda", {"deep": 0})
    port = KernelPolicy.load(mine.save(str(tmp_path / "port.json")))
    ops.ensemble_vote(m, a, backend="cuda", policy=port)
    assert stub.calls[-1][1] == {"deep": 0} == port.cuda_layout_choices[key]
    assert port.layout_choices[key] == dispatch.DEFAULT_LAYOUTS[
        "ensemble_vote"]


def test_mixed_layout_refused_on_load_and_in_a_table(tmp_path):
    p = tmp_path / "mixed.json"
    p.write_text(json.dumps({
        "version": 2, "backend": None, "measured_on": "cpu",
        "table": [{"kernel": "ensemble_vote", "bucket": [8, 128],
                   "backend": "cuda",
                   "layout": {"block_n": 256, "deep": 1}}]}))
    with pytest.raises(ValueError, match="mixes"):
        KernelPolicy.load(str(p))
    with pytest.raises(ValueError, match="mixes"):
        KernelPolicy(table={("ensemble_vote", (8, 128)):
                            ("cuda", {"block_t": 64, "cols": 8})})


def test_save_load_round_trips_cuda_layouts(tmp_path):
    pol = KernelPolicy(env_var=None)
    for kernel, grid in LAYOUT_GRIDS.items():
        pol.record(kernel, (1, 2, 3), "cuda", grid[-1])
    pol.record("dist_update", (8192,), "torch")
    path = pol.save(str(tmp_path / "cal.json"))
    data = json.loads(open(path).read())
    assert data["version"] == 2 and data["measured_on"] == "cpu"
    assert {e["kernel"]: e["layout"] for e in data["table"]
            if e["backend"] == "cuda"} == {
        k: g[-1] for k, g in LAYOUT_GRIDS.items()}
    back = KernelPolicy.load(path)
    assert back.table == pol.table
    assert back.cuda_layout_for("dist_update", (1, 2, 3), "cuda") == \
        LAYOUT_GRIDS["dist_update"][-1]


# ------------------------------------------------------------- the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# two calls a kernel (numpy, made in the test that takes them)
CARD_CASES = {
    "stump_scan": (lambda: scan_case(0, 333, 64, 16),
                   lambda: scan_case(1, 2400, 64, 16)),
    "stump_scan_batched": (lambda: batched_scan_case(2, 50, 40, 12, 16),
                           lambda: batched_scan_case(3, 30, 20, 9, 13)),
    "ensemble_vote": (lambda: margins_case(4, (300, 1000)),
                      lambda: margins_case(5, (256, 8192))),
    "ensemble_vote_batched": (lambda: margins_case(6, (2, 300, 64)),
                              lambda: margins_case(7, (8, 1024, 4096))),
    "stump_vote_batched": (lambda: vote_case(8, 2, 300, 64),
                           lambda: vote_case(9, 8, 600, 4096)),
    "stump_vote_fp_batched": (lambda: vote_case(10, 2, 300, 61),
                              lambda: vote_case(11, 3, 600, 1000)),
    "dist_update": (lambda: dist_case(12, 8192),
                    lambda: dist_case(13, 40001)),
}


def _both(kernel, args, layout):
    """The kernel at ``layout`` on the card and the plain version, both
    through the dispatcher; asserts one launch."""
    fn = getattr(ops, kernel)
    before = ops.LAUNCHES[kernel]
    got = fn(*args, backend="cuda", policy=KernelPolicy(env_var=None),
             **layout)
    want = fn(*args, backend="torch", policy=KernelPolicy(env_var=None))
    torch.cuda.synchronize()
    assert ops.LAUNCHES[kernel] == before + 1
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,layout", [
    (k, m) for k in CARD_CASES for m in LAYOUT_GRIDS[k]],
    ids=lambda v: v if isinstance(v, str) else dispatch.layout_label(v))
def test_every_grid_member_matches_plain_on_card(card, kernel, layout):
    for case in CARD_CASES[kernel]:
        args = tensors(case(), card)
        bucket = bucket_of(kernel, args)
        if not dispatch.layout_applies(kernel, bucket, layout):
            with pytest.raises(RuntimeError, match="CUDA error"):
                getattr(ops, kernel)(*args, backend="cuda", **layout)
            continue
        got, want = _both(kernel, args, layout)
        if kernel.startswith("stump_scan"):
            assert torch.equal(got, want)
        elif kernel == "dist_update":
            torch.testing.assert_close(got[0], want[0], rtol=0, atol=1e-6)
            torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=0)
        elif kernel == "stump_vote_fp_batched":
            torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-5)
            assert torch.equal(got[1], want[1]) and \
                torch.equal(got[2], want[2])
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUT_GRIDS["flash_attention"],
                         ids=dispatch.layout_label)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("shape,causal", [((2, 4, 200, 64), True),
                                          ((1, 2, 333, 128), True),
                                          ((1, 2, 130, 80), False)])
def test_every_flash_member_matches_plain_on_card(card, layout, dtype, tol,
                                                  shape, causal):
    q, k, v = (t.to(dtype) for t in tensors(flash_case(14, *shape), card))
    before = ops.LAUNCHES["flash_attention"]
    got = ops.flash_attention(q, k, v, causal=causal, backend="cuda",
                              **layout)
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert ops.LAUNCHES["flash_attention"] == before + 1
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    again = ops.flash_attention(q, k, v, causal=causal, backend="cuda",
                                **layout)
    assert torch.equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,case,layout", [
    ("stump_scan", CARD_CASES["stump_scan"][0], {"cols": 3}),
    ("stump_scan", CARD_CASES["stump_scan"][0], {"cols": 8, "blocks": 513}),
    ("stump_scan_batched", CARD_CASES["stump_scan_batched"][0],
     {"threads": 48}),
    ("stump_scan_batched", CARD_CASES["stump_scan_batched"][0],
     {"depth": 2}),
    ("ensemble_vote", CARD_CASES["ensemble_vote"][0], {"deep": 2}),
    ("stump_vote_batched", CARD_CASES["stump_vote_batched"][0],
     {"tile_c": 4, "groups": 2}),
    ("stump_vote_fp_batched", CARD_CASES["stump_vote_fp_batched"][0],
     {"tile_c": 2, "deep": 0, "groups": 2}),
    ("stump_vote_batched", CARD_CASES["stump_vote_batched"][0],
     {"tile_c": 8}),
    ("dist_update", CARD_CASES["dist_update"][1], {"cluster": 1}),
    ("dist_update", CARD_CASES["dist_update"][0], {"threads": 48}),
    ("flash_attention", lambda: flash_case(14, 2, 4, 200, 128),
     {"stages": 3}),
    ("flash_attention", lambda: flash_case(14, 2, 4, 200, 64),
     {"stages": 4}),
], ids=lambda v: v if isinstance(v, str) else (
    dispatch.layout_label(v) if isinstance(v, dict) else "case"))
def test_launcher_refuses_a_launch_it_cannot_run(card, kernel, case, layout):
    """Never the launcher's own choice in its place: the call raises and
    nothing is counted."""
    args = tensors(case(), card)
    before = ops.LAUNCHES[kernel]
    with pytest.raises(RuntimeError, match="CUDA error"):
        getattr(ops, kernel)(*args, backend="cuda", **layout)
    assert ops.LAUNCHES[kernel] == before


@pytest.mark.cuda
def test_calibrated_layout_reaches_the_card(card, tmp_path):
    args = tensors(CARD_CASES["stump_vote_batched"][0](), card)
    pol = KernelPolicy(env_var=None)
    bucket, samples = pol.calibrate_call("stump_vote_batched", *args, reps=3)
    assert len(samples) == 1 + len(LAYOUT_GRIDS["stump_vote_batched"])
    back = KernelPolicy.load(pol.save(str(tmp_path / "cal.json")))
    got = ops.stump_vote_batched(*args, policy=back)
    entry = back.table[("stump_vote_batched", bucket)]
    assert back.choices[("stump_vote_batched", bucket)] == entry.backend
    assert back.cuda_layout_choices[("stump_vote_batched", bucket)] == (
        dict(entry.layout) if entry.backend == "cuda" else {})
    want = ops.stump_vote_batched(*args, backend="torch")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
