"""The port's kernel dispatcher against the JAX package's: resolution
order, shape buckets (the reference's tuples for the same shapes), the v2
calibration table (JAX-package tables included), the recorded layouts,
the profiling path and ``calibration_check``, and per-call re-resolution
in the serving evaluator.  The JAX package's three ``interpret=`` shim
tests have no counterpart: the port has no interpreter substrate."""
import json
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import dispatch as jdispatch  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.kernels import dispatch, ops, ref  # noqa: E402
from repro_torch.kernels.dispatch import (  # noqa: E402
    BACKENDS, DEFAULT_LAYOUTS, ENV_VAR, CalEntry, KernelPolicy, bucket_label,
    bucket_of, calibration_check, canonical, layout_key, platform_default)
from repro_torch.obs import trace  # noqa: E402
from repro_torch.obs.registry import MetricsRegistry  # noqa: E402


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    monkeypatch.delenv(ENV_VAR, raising=False)
    monkeypatch.delenv(jdispatch.ENV_VAR, raising=False)


def _vote_case(T=9, N=33, seed=0):
    rng = np.random.RandomState(seed)
    m = np.sign(rng.randn(T, N)).astype(np.float32)
    a = rng.randn(T).astype(np.float32)
    return torch.from_numpy(m), torch.from_numpy(a)


def _stump_vote_args(B=1, T=4, N=8, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(a) for a in (
        rng.randn(B, T, N).astype(np.float32),
        rng.randn(B, T).astype(np.float32),
        np.sign(rng.randn(B, T)).astype(np.float32),
        rng.rand(B, T).astype(np.float32)))


# -------------------------------------------------------- resolution order

def test_resolution_priority_chain(monkeypatch):
    bucket = (8, 128)
    pol = KernelPolicy()
    # the platform default of the call's device at the bottom
    assert pol.resolve_name("ensemble_vote", bucket, device="cpu") == "torch"
    assert pol.resolve_name("ensemble_vote", bucket, device="cuda") == "cuda"
    # calibration table beats platform default
    pol.record("ensemble_vote", bucket, "torch")
    assert pol.resolve_name("ensemble_vote", bucket, device="cuda") == "torch"
    # env var beats the table
    monkeypatch.setenv(ENV_VAR, "cuda")
    assert pol.resolve_name("ensemble_vote", bucket, device="cuda") == "cuda"
    # forced policy backend beats env
    forced = KernelPolicy(backend="torch")
    assert forced.resolve_name("ensemble_vote", bucket,
                               device="cuda") == "torch"
    # explicit per-call arg beats everything
    assert forced.resolve_name("ensemble_vote", bucket, explicit="cuda",
                               device="cuda") == "cuda"


def test_unavailable_backend_falls_through():
    pol = KernelPolicy()
    with pytest.warns(RuntimeWarning, match="unavailable"):
        name = pol.resolve_name("ensemble_vote", (8, 128), explicit="cuda",
                                device="cpu")
    assert name == "torch"
    # a cuda-calibrated table degrades on CPU tensors too
    pol2 = KernelPolicy(table={("ensemble_vote", (8, 128)): "cuda"})
    with pytest.warns(RuntimeWarning):
        assert pol2.resolve_name("ensemble_vote", (8, 128),
                                 device="cpu") == "torch"


def test_cuda_on_cpu_tensors_warns_once_and_runs_the_plain_version():
    m, a = _vote_case()
    pol = KernelPolicy(backend="cuda")
    ops.reset_launches()
    with pytest.warns(RuntimeWarning, match="'cuda' is unavailable"):
        got = ops.ensemble_vote(m, a, policy=pol)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        again = ops.ensemble_vote(m, a, policy=pol)
        ops.ensemble_vote(*_vote_case(T=300, N=9), policy=pol)
    assert torch.equal(got, again)
    assert torch.equal(got, ref.ensemble_vote_ref(m, a))
    assert set(pol.choices.values()) == {"torch"}
    assert sum(ops.LAUNCHES.values()) == 0     # the plain version launches
    # the cuda backend itself never runs the plain version
    with pytest.raises(ValueError, match="CUDA tensors"):
        BACKENDS["cuda"].run("ensemble_vote", m, a)


def test_env_change_takes_effect_without_rebuild(monkeypatch):
    """The dispatch cache must never pin a stale env-driven choice."""
    pol = KernelPolicy()
    bucket = (8, 128)
    assert pol.resolve("ensemble_vote", bucket, device="cuda").name == "cuda"
    monkeypatch.setenv(ENV_VAR, "plain")
    assert pol.resolve("ensemble_vote", bucket, device="cuda").name == \
        "torch"
    monkeypatch.setenv(ENV_VAR, "gpu")
    assert pol.resolve("ensemble_vote", bucket, device="cuda").name == "cuda"
    # through a wrapper: the choice of the live env value is recorded
    m, a = _vote_case()
    monkeypatch.setenv(ENV_VAR, "torch")
    ops.ensemble_vote(m, a, policy=pol)
    assert pol.choices[("ensemble_vote",
                        bucket_of("ensemble_vote", (m, a)))] == "torch"


def test_env_variable_is_the_ports_own(monkeypatch):
    """Each package reads its own variable: one process imports both."""
    assert ENV_VAR == "REPRO_TORCH_KERNEL_BACKEND" != jdispatch.ENV_VAR
    pol, jpol = KernelPolicy(), jdispatch.KernelPolicy()
    monkeypatch.setenv(jdispatch.ENV_VAR, "xla")
    assert pol.resolve_name("ensemble_vote", (8, 128),
                            device="cuda") == "cuda"
    assert jpol.resolve_name("ensemble_vote", (8, 128)) == "xla"
    monkeypatch.delenv(jdispatch.ENV_VAR)
    monkeypatch.setenv(ENV_VAR, "torch")
    assert pol.resolve_name("ensemble_vote", (8, 128),
                            device="cuda") == "torch"
    assert jpol.resolve_name("ensemble_vote", (8, 128)) == \
        jdispatch.platform_default()


def test_device_change_not_masked_by_dispatch_cache():
    """The cache key holds the call's device type: a CPU call and a card
    call of one bucket resolve apart, as the reference keys on its
    platform."""
    pol = KernelPolicy()
    bucket = (8, 128)
    assert pol.resolve("ensemble_vote", bucket, device="cpu").name == "torch"
    assert pol.resolve("ensemble_vote", bucket, device="cuda").name == "cuda"
    assert pol.resolve("ensemble_vote", bucket, device="cpu").name == "torch"
    assert pol.cache_hits == 1


def test_canonical_names_and_aliases():
    assert canonical("TORCH") == "torch"
    # each of the reference's names keeps its role: the oracle or the
    # kernel
    for name in ("xla", "ref", "jnp", "fallback"):
        assert jdispatch.canonical(name) == "xla"
        assert canonical(name) == "torch"
    for name in ("mosaic", "pallas_mosaic", "tpu"):
        assert jdispatch.canonical(name) == "mosaic"
        assert canonical(name) == "cuda"
    assert canonical("plain") == "torch"
    assert canonical("gpu") == canonical("CUDA") == "cuda"
    # an interpreter pin has no meaning on the card: refused like an
    # unknown name, with the reference's error
    for name in ("interpret", "pallas", "pallas_interpret", "triton"):
        with pytest.raises(KeyError, match="unknown kernel backend"):
            canonical(name)
    assert sorted(BACKENDS) == ["cuda", "torch"]


# --------------------------------------------------------------- bucketing

def _np_args(kernel, shape):
    """Zero arguments of one kernel at ``shape`` for both packages."""
    z = lambda *s: np.zeros(s, np.float32)  # noqa: E731
    if kernel == "stump_scan":
        N, F, T = shape
        return (z(N, F), z(N), z(N), z(F, T))
    if kernel == "stump_scan_batched":
        B, N, F, T = shape
        return (z(B, N, F), z(B, N), z(B, N), z(B, F, T))
    if kernel == "ensemble_vote":
        T, N = shape
        return (z(T, N), z(T))
    if kernel == "ensemble_vote_batched":
        B, T, N = shape
        return (z(B, T, N), z(B, T))
    if kernel in ("stump_vote_batched", "stump_vote_fp_batched"):
        B, T, N = shape
        return (z(B, T, N), z(B, T), z(B, T), z(B, T))
    if kernel == "flash_attention":
        B, H, T, d = shape
        q = z(B, H, T, d)
        return (q, q, q)
    (N,) = shape
    return (np.float32(0.5), z(N), z(N), z(N))


RAGGED = {
    "stump_scan": [(1, 1, 1), (37, 5, 3), (333, 64, 16), (477, 24, 16),
                   (1023, 13, 21), (4099, 64, 40)],
    "stump_scan_batched": [(1, 1, 1, 1), (3, 7, 5, 3), (8, 333, 64, 16),
                           (13, 300, 24, 16), (100, 60, 48, 16)],
    "ensemble_vote": [(1, 1), (5, 90), (7, 100), (9, 300), (300, 64),
                      (1024, 65536)],
    "ensemble_vote_batched": [(1, 1, 1), (3, 37, 100), (2, 300, 64),
                              (8, 1024, 4096)],
    "stump_vote_batched": [(1, 477, 1), (2, 300, 64), (3, 24, 7),
                           (5, 129, 513), (8, 1024, 4096)],
    "stump_vote_fp_batched": [(1, 477, 1), (2, 300, 64), (6, 20, 1000)],
    "flash_attention": [(1, 2, 192, 64), (4, 16, 512, 64), (1, 1, 97, 80),
                        (2, 3, 1000, 128)],
    "dist_update": [(1,), (255,), (257,), (1025,), (8192,), (100_003,)],
}


@pytest.mark.parametrize("kernel,shape", [(k, s) for k, v in RAGGED.items()
                                          for s in v])
def test_bucket_equals_the_references(kernel, shape):
    args = _np_args(kernel, shape)
    want = jdispatch.bucket_of(kernel, args)
    targs = tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                  for a in args)
    assert bucket_of(kernel, targs) == want
    assert bucket_label(bucket_of(kernel, targs)) == \
        jdispatch.bucket_label(want)


def test_ragged_shapes_share_buckets_and_dispatch_cache():
    b1 = bucket_of("ensemble_vote", _vote_case(T=5, N=90))
    b2 = bucket_of("ensemble_vote", _vote_case(T=7, N=100))
    assert b1 == b2
    assert bucket_of("ensemble_vote", _vote_case(T=9, N=300)) != b1
    pol = KernelPolicy()
    ops.ensemble_vote(*_vote_case(T=5, N=90), policy=pol)
    hits0 = pol.cache_hits
    ops.ensemble_vote(*_vote_case(T=7, N=100), policy=pol)
    assert pol.cache_hits == hits0 + 1


def test_batched_bucket_tracks_padded_dims():
    m = torch.zeros((3, 37, 100))
    a = torch.zeros((3, 37))
    assert bucket_of("ensemble_vote_batched", (m, a)) == (4, 64, 128) == \
        jdispatch.bucket_of("ensemble_vote_batched",
                            (jnp.zeros((3, 37, 100)), jnp.zeros((3, 37))))


def test_bucketing_is_layout_canonical():
    m, a = _vote_case(T=6, N=50)
    base = bucket_of("ensemble_vote", (m, a))
    for layout in ({"block_t": 64, "block_n": 256},
                   {"block_t": 256, "block_n": 2048},
                   {"block_t": None, "block_n": None}):
        assert bucket_of("ensemble_vote", (m, a), layout) == base
    x = torch.zeros((100, 5))
    args = (x, torch.ones(100), torch.ones(100), torch.zeros((5, 6)))
    assert (bucket_of("stump_scan", args, {"block_n": 1024})
            == bucket_of("stump_scan", args))
    q = torch.zeros((1, 2, 192, 64))
    assert (bucket_of("flash_attention", (q, q, q), {"block_q": 64,
                                                     "block_k": 64})
            == bucket_of("flash_attention", (q, q, q)))


def test_dist_update_buckets_from_D_alone():
    """A tensor alpha (on any device) plays no part in the bucket or in the
    call's device."""
    D = torch.full((300,), 1 / 300)
    y = torch.ones(300)
    h = -torch.ones(300)
    for alpha in (0.25, torch.tensor(0.25), torch.tensor([0.25])):
        assert bucket_of("dist_update", (alpha, D, y, h)) == (512,)
        assert dispatch.call_device("dist_update",
                                    (alpha, D, y, h)).type == "cpu"
    got = ops.dist_update(torch.tensor(0.25), D, y, h)
    want = jref.dist_update_ref(jnp.float32(0.25), jnp.asarray(D.numpy()),
                                jnp.asarray(y.numpy()),
                                jnp.asarray(h.numpy()))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)


# ------------------------------------------------------------- calibration

def test_calibration_roundtrip(tmp_path):
    pol = KernelPolicy()
    m, a = _vote_case(T=6, N=50)
    bucket, samples = pol.calibrate_call("ensemble_vote", m, a, reps=2)
    assert bucket == bucket_of("ensemble_vote", (m, a)) == \
        jdispatch.bucket_of("ensemble_vote", (m.numpy(), a.numpy()))
    # keys are (backend, layout_key): each available backend once, with
    # the empty layout (no backend here has a block layout)
    assert set(samples) == {("torch", ())}
    assert all(len(ts) == 2 for ts in samples.values())
    winner = pol.table[("ensemble_vote", bucket)]
    assert winner == CalEntry("torch", ())
    path = pol.save(str(tmp_path / "cal.json"))
    data = json.loads((tmp_path / "cal.json").read_text())
    assert data["version"] == 2 and data["measured_on"] == "cpu"
    loaded = KernelPolicy.load(path)
    assert loaded.table == pol.table
    assert loaded.resolve_name("ensemble_vote", bucket,
                               device="cuda") == "torch"
    # an uncalibrated bucket still takes the platform default
    assert loaded.resolve_name("ensemble_vote", (1024, 4096),
                               device="cuda") == "cuda"
    with pytest.raises(ValueError, match="no backend"):
        pol.calibrate_call("ensemble_vote", m, a, reps=1, backends=["cuda"])


def test_v1_table_loads_transparently(tmp_path):
    p = tmp_path / "cal_v1.json"
    p.write_text(json.dumps({
        "env_var": ENV_VAR, "backend": None,
        "table": [{"kernel": "ensemble_vote", "bucket": [8, 128],
                   "backend": "xla"}]}))
    loaded = KernelPolicy.load(str(p))
    assert loaded.table[("ensemble_vote", (8, 128))] == CalEntry("torch", ())
    assert loaded.resolve_name("ensemble_vote", (8, 128),
                               device="cuda") == "torch"
    loaded.save(str(tmp_path / "cal_v2.json"))
    again = KernelPolicy.load(str(tmp_path / "cal_v2.json"))
    assert again.table == loaded.table


def test_jax_package_tables_load(tmp_path):
    """A v2 table the JAX package wrote (xla and mosaic winners, tuned
    layouts, its env variable) loads with each pin in its role, keeps its
    layouts through a save, and reads the port's variable."""
    jpol = jdispatch.KernelPolicy()
    jpol.record("stump_vote_batched", (1, 512, 128), "xla",
                {"block_t": 64, "block_n": 256})
    jpol.record("stump_scan", (512, 24, 16), "mosaic", {"block_n": 512})
    jpath = jpol.save(str(tmp_path / "jax_cal.json"), measured_on="cpu")
    pol = KernelPolicy.load(jpath)
    assert pol.table == {
        ("stump_vote_batched", (1, 512, 128)):
            CalEntry("torch", (("block_n", 256), ("block_t", 64))),
        ("stump_scan", (512, 24, 16)): CalEntry("cuda", (("block_n", 512),))}
    assert pol.env_var == ENV_VAR
    assert pol.measured_on == "cpu"
    pol.save(str(tmp_path / "back.json"))
    assert KernelPolicy.load(str(tmp_path / "back.json")).table == pol.table
    # the layouts are recorded, never launched
    captured = []
    real = dispatch._TORCH_IMPLS["stump_vote_batched"]

    def spy(*args, **kwargs):
        captured.append(kwargs)
        return real(*args, **kwargs)
    args = _stump_vote_args(1, 300, 64)
    bucket = bucket_of("stump_vote_batched", args)
    pol.record("stump_vote_batched", bucket, "torch",
               {"block_t": 64, "block_n": 256})
    dispatch._TORCH_IMPLS["stump_vote_batched"] = spy
    try:
        ops.stump_vote_batched(*args, policy=pol)
    finally:
        dispatch._TORCH_IMPLS["stump_vote_batched"] = real
    assert captured == [{}]
    assert pol.layout_choices[("stump_vote_batched", bucket)] == \
        {"block_t": 64, "block_n": 256}


def test_future_schema_version_rejected(tmp_path):
    p = tmp_path / "cal_v99.json"
    p.write_text(json.dumps({"version": 99, "table": []}))
    with pytest.raises(ValueError, match="schema v99"):
        KernelPolicy.load(str(p))
    with pytest.raises(ValueError, match="schema v99"):
        jdispatch.KernelPolicy.load(str(p))


def test_save_records_measuring_platform(tmp_path):
    pol = KernelPolicy()
    pol.record("ensemble_vote", (8, 128), "torch")
    path = pol.save(str(tmp_path / "cal.json"))
    data = json.loads((tmp_path / "cal.json").read_text())
    assert data["measured_on"] == dispatch.platform() == "cpu"
    assert KernelPolicy.load(path).measured_on == "cpu"
    pol.save(str(tmp_path / "cal_cuda.json"), measured_on="cuda")
    assert json.loads(
        (tmp_path / "cal_cuda.json").read_text())["measured_on"] == "cuda"


def test_cross_platform_table_warns_exactly_once(tmp_path):
    p = tmp_path / "cal_other.json"
    p.write_text(json.dumps({
        "version": 2, "backend": None, "measured_on": "cuda",
        "table": [{"kernel": "ensemble_vote", "bucket": [8, 128],
                   "backend": "torch", "layout": {}}]}))
    dispatch._PLATFORM_WARNED.discard(("cuda", "cpu"))
    with pytest.warns(RuntimeWarning, match="measured on 'cuda'"):
        loaded = KernelPolicy.load(str(p))
    assert loaded.measured_on == "cuda"
    assert loaded.resolve_name("ensemble_vote", (8, 128),
                               device="cpu") == "torch"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        KernelPolicy.load(str(p))
    dispatch._PLATFORM_WARNED.discard(("cuda", "cpu"))


def test_same_platform_and_empty_tables_load_silently(tmp_path):
    same = tmp_path / "cal_same.json"
    same.write_text(json.dumps({
        "version": 2, "backend": None, "measured_on": "cpu",
        "table": [{"kernel": "ensemble_vote", "bucket": [8, 128],
                   "backend": "torch", "layout": {}}]}))
    empty = tmp_path / "cal_empty.json"
    empty.write_text(json.dumps({
        "version": 2, "backend": None, "measured_on": "tpu", "table": []}))
    v1 = tmp_path / "cal_v1.json"
    v1.write_text(json.dumps({
        "table": [{"kernel": "ensemble_vote", "bucket": [8, 128],
                   "backend": "xla"}]}))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert KernelPolicy.load(str(same)).measured_on == "cpu"
        KernelPolicy.load(str(empty))
        assert KernelPolicy.load(str(v1)).measured_on is None


# ------------------------------------------------------------ layout record

def _spy_backend(monkeypatch, name, captured):
    be = BACKENDS[name]
    orig = type(be).run

    def run(kernel, *args, **kwargs):
        captured.append(dict(kwargs))
        return orig(be, kernel, *args, **kwargs)
    monkeypatch.setattr(be, "run", run)


def test_layout_choices_equal_the_references():
    """For the same calls and tables, the port records the layout the JAX
    package launches with (tuned where the winner matches, the reference
    layout elsewhere, explicit kwargs over both)."""
    m, a = _vote_case(T=6, N=50)
    bucket = bucket_of("ensemble_vote", (m, a))
    tuned = {"block_t": 64, "block_n": 256}
    pol = KernelPolicy(table={("ensemble_vote", bucket): ("torch", tuned)})
    jpol = jdispatch.KernelPolicy(
        table={("ensemble_vote", bucket): ("xla", tuned)})
    jm, ja = jnp.asarray(m.numpy()), jnp.asarray(a.numpy())
    from repro.kernels import ops as jops
    for kw in ({}, {"block_t": 128}):
        out = ops.ensemble_vote(m, a, policy=pol, **kw)
        jout = jops.ensemble_vote(jm, ja, policy=jpol, **kw)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                   rtol=1e-5, atol=1e-5)
        assert pol.layout_choices == jpol.layout_choices
    assert pol.layout_choices[("ensemble_vote", bucket)] == \
        {"block_t": 128, "block_n": 256}


def test_tuned_layout_never_reaches_the_backend(monkeypatch):
    m, a = _vote_case(T=6, N=50)
    bucket = bucket_of("ensemble_vote", (m, a))
    pol = KernelPolicy(table={
        ("ensemble_vote", bucket): ("torch", {"block_t": 64,
                                              "block_n": 256})})
    captured = []
    _spy_backend(monkeypatch, "torch", captured)
    ops.ensemble_vote(m, a, policy=pol)
    ops.ensemble_vote(m, a, policy=pol, block_t=128)
    assert captured == [{}, {}]
    assert pol.layout_choices[("ensemble_vote", bucket)] == \
        {"block_t": 128, "block_n": 256}


def test_tuned_layout_not_leaked_to_other_backend():
    """A layout recorded for one backend says nothing about another: a
    call resolving elsewhere records the reference layout."""
    m, a = _vote_case(T=6, N=50)
    bucket = bucket_of("ensemble_vote", (m, a))
    pol = KernelPolicy(table={
        ("ensemble_vote", bucket): ("cuda", {"block_t": 64,
                                             "block_n": 256})})
    with pytest.warns(RuntimeWarning):
        ops.ensemble_vote(m, a, policy=pol)
    assert pol.layout_choices[("ensemble_vote", bucket)] == \
        DEFAULT_LAYOUTS["ensemble_vote"]


def test_none_layout_kwargs_resolve_to_reference_layout(monkeypatch):
    m, a = _vote_case(T=6, N=50)
    captured = []
    _spy_backend(monkeypatch, "torch", captured)
    pol = KernelPolicy()
    ops.ensemble_vote(m, a, policy=pol, backend="torch")
    assert captured[-1] == {}
    assert pol.layout_choices[("ensemble_vote", bucket_of(
        "ensemble_vote", (m, a)))] == DEFAULT_LAYOUTS["ensemble_vote"]


def test_table_accepts_legacy_string_values():
    pol = KernelPolicy(table={("ensemble_vote", (8, 128)): "xla"})
    assert pol.table[("ensemble_vote", (8, 128))] == CalEntry("torch", ())
    assert layout_key({"block_n": 256, "block_t": 64}) == \
        (("block_n", 256), ("block_t", 64)) == \
        jdispatch.layout_key({"block_n": 256, "block_t": 64})


def test_flash_attention_out_passes_through_the_torch_backend():
    rng = np.random.RandomState(3)
    q, k, v = (rng.randn(1, 2, 16, 8).astype(np.float32) for _ in range(3))
    buf = torch.zeros((1, 16, 2, 8))
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              out=buf.transpose(1, 2), backend="torch")
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v))
    np.testing.assert_allclose(buf.transpose(1, 2).numpy(), np.asarray(want),
                               rtol=2e-4, atol=2e-4)
    assert got.data_ptr() == buf.data_ptr()


# --------------------------------------------------------------- profiling

def test_dispatch_profiling_records_launches_and_wall_time():
    """A traced dispatch: one span, the launches counted, the first call's
    host seconds in ``kernel.compile_s``, the next one's in
    ``kernel.dispatch_s`` and, on CPU tensors, ``kernel.device_s``."""
    args = _stump_vote_args()
    with obs.tracing() as tr:
        out = dispatch.dispatch("stump_vote_batched", args, backend="torch")
        out2 = dispatch.dispatch("stump_vote_batched", args,
                                 backend="plain")
        obs.resolve()
        reg = obs.get_registry()
        hosts = [(labels, h) for name, labels, h in reg.histograms()
                 if name == "kernel.dispatch_s"]
        compiles = [(labels, h) for name, labels, h in reg.histograms()
                    if name == "kernel.compile_s"]
        devices = [(labels, h) for name, labels, h in reg.histograms()
                   if name == "kernel.device_s"]
        counters = [(labels, c) for name, labels, c in reg.counters()
                    if name == "kernel.launches"]
        spans = tr.finished()
    assert out.shape == out2.shape == (1, 8)
    assert len(hosts) == 1 and len(compiles) == 1 and len(counters) == 1
    assert len(devices) == 1
    labels, h = hosts[0]
    assert labels == {"kernel": "stump_vote_batched",
                      "bucket": jdispatch.bucket_label(jdispatch.bucket_of(
                          "stump_vote_batched",
                          tuple(t.numpy() for t in args))),
                      "backend": "torch"}
    assert h.count == 1 and h.sum > 0
    clabels, ch = compiles[0]
    assert clabels == labels
    assert ch.count == 1 and ch.sum > 0
    assert counters[0][1].value == 2
    ksp = [d for d in spans if d["name"].startswith("kernel.")]
    assert [d["name"] for d in ksp] == ["kernel.stump_vote_batched"] * 2
    assert ksp[0]["attrs"] == {"backend": "torch", "bucket": labels["bucket"]}
    assert h.sum == pytest.approx(ksp[1]["t1"] - ksp[1]["t0"])
    assert devices[0][0] == labels and devices[0][1].sum == h.sum


class _FakeEvent:
    """A CUDA event on the host clock: what a span records on a card."""
    synced = 0

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        import time
        self.t = time.perf_counter()

    def query(self):
        return True

    def synchronize(self):
        _FakeEvent.synced += 1

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3


def test_traced_dispatch_on_a_card_fills_device_s(monkeypatch):
    """Where the call's tensors lie on a card, the span carries an event
    pair; ``obs.resolve`` waits once and puts each steady call's device
    seconds into ``kernel.device_s`` (read by ``calibration_check``)."""
    class CountingBackend:
        name = "counting"

        def available(self, device):
            return True

        def run(self, kernel, *args, **kwargs):
            return torch.zeros((args[0].shape[0], args[0].shape[2]))

    monkeypatch.setitem(BACKENDS, "counting", CountingBackend())
    monkeypatch.setattr(dispatch, "call_device",
                        lambda *a, **k: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(trace, "_current_stream", lambda: None)
    monkeypatch.setattr(_FakeEvent, "synced", 0)
    args = _stump_vote_args()
    with obs.tracing() as tr:
        for _ in range(4):
            dispatch.dispatch("stump_vote_batched", args, backend="counting")
        assert "device_ms" not in tr.finished()[-1]["attrs"]
        obs.resolve()
        reg = obs.get_registry()
        dev = [h for name, _, h in reg.histograms()
               if name == "kernel.device_s"]
        spans = tr.finished()
    assert _FakeEvent.synced == 1
    assert all(d["attrs"]["device_ms"] >= 0 for d in spans)
    assert len(dev) == 1 and dev[0].count == 3
    assert dev[0].sum == pytest.approx(
        sum(d["attrs"]["device_ms"] for d in spans[1:]) * 1e-3)
    obs.resolve()                              # nothing left to wait for
    assert _FakeEvent.synced == 1


def test_profiled_dispatch_on_a_card_records_no_events(monkeypatch):
    """Under a torch profiler alone, a call on a card opens its span and
    range but records no event pair: no reader of the profiled tracer
    reads a kernel's ``device_ms``, and ``kernel.device_s`` stays
    empty."""
    from torch.profiler import ProfilerActivity, profile

    class CountingBackend:
        name = "counting"

        def available(self, device):
            return True

        def run(self, kernel, *args, **kwargs):
            return torch.zeros((args[0].shape[0], args[0].shape[2]))

    def no_event(*a, **k):
        raise AssertionError("an event recorded under the profiler alone")

    monkeypatch.setitem(BACKENDS, "counting", CountingBackend())
    monkeypatch.setattr(dispatch, "call_device",
                        lambda *a, **k: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    obs.disable()
    if obs.profiled_tracer() is not None:
        obs.profiled_tracer().clear()
    reg = MetricsRegistry()
    old = obs.set_registry(reg)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(3):
                dispatch.dispatch("stump_vote_batched", _stump_vote_args(),
                                  backend="counting")
        obs.resolve()
    finally:
        obs.set_registry(old)
    spans = obs.profiled_tracer().finished()
    assert [d["name"] for d in spans] == ["kernel.stump_vote_batched"] * 3
    assert not any("device_ms" in d["attrs"] for d in spans)
    names = {name for name, _, h in reg.histograms() if h.count}
    assert names == {"kernel.compile_s", "kernel.dispatch_s"}


def test_traced_dispatch_never_synchronizes(monkeypatch, tmp_path):
    """A traced dispatch, its resolve and its export run to the end with
    ``torch.cuda.synchronize`` raising."""
    def refuse(*a, **k):
        raise AssertionError("synchronize on a traced dispatch")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    args = _stump_vote_args()
    with obs.tracing() as tr:
        for _ in range(2):
            out = dispatch.dispatch("stump_vote_batched", args,
                                    backend="torch")
        obs.resolve()
        path = tr.export_jsonl(tmp_path / "kernel.jsonl")
    assert out.shape == (1, 8)
    assert [d["name"] for d in obs.load_jsonl(path)] == \
        ["kernel.stump_vote_batched"] * 2


def test_first_seen_split_is_per_kernel_bucket_backend():
    class CountingBackend:
        name = "counting"
        calls = 0

        def available(self, device):
            return True

        def run(self, kernel, *args, **kwargs):
            CountingBackend.calls += 1
            return torch.zeros((args[0].shape[0], args[0].shape[2]))

    BACKENDS["counting"] = CountingBackend()
    try:
        with obs.tracing():
            small, big = _stump_vote_args(1, 4, 8), _stump_vote_args(1, 4, 600)
            for _ in range(3):
                dispatch.dispatch("stump_vote_batched", small,
                                  backend="counting")
            dispatch.dispatch("stump_vote_batched", big, backend="counting")
            reg = obs.get_registry()
            compiles = [(labels, h) for name, labels, h
                        in reg.histograms() if name == "kernel.compile_s"]
            hosts = [(labels, h) for name, labels, h in reg.histograms()
                     if name == "kernel.dispatch_s"]
    finally:
        BACKENDS.pop("counting")
    assert CountingBackend.calls == 4
    assert len(compiles) == 2
    assert all(h.count == 1 for _, h in compiles)
    assert len(hosts) == 1 and hosts[0][1].count == 2


def test_dispatch_unprofiled_records_nothing():
    obs.disable()
    reg = MetricsRegistry()
    old = obs.set_registry(reg)
    try:
        dispatch.dispatch("stump_vote_batched", _stump_vote_args(),
                          backend="torch")
        assert len(reg) == 0
        assert not obs.active()
    finally:
        obs.set_registry(old)


def test_calibration_check_flags_stale_winner():
    reg = MetricsRegistry()
    bucket = (128, 8, 8)
    bl = bucket_label(bucket)
    for _ in range(20):
        reg.histogram("kernel.device_s", kernel="k", bucket=bl,
                      backend="cuda").observe(5e-3)      # calibrated winner
        reg.histogram("kernel.device_s", kernel="k", bucket=bl,
                      backend="torch").observe(1e-3)     # actually faster
        # host seconds of the same calls are not what calibration reads
        reg.histogram("kernel.dispatch_s", kernel="k", bucket=bl,
                      backend="cuda").observe(1e-6)
    pol = KernelPolicy(table={("k", bucket): "cuda"}, env_var=None)
    flags = calibration_check(policy=pol, registry=reg)
    assert len(flags) == 1
    assert flags[0]["calibrated"] == "cuda"
    assert flags[0]["observed_best"] == "torch"
    assert flags[0]["observed_best_p50_s"] < flags[0]["calibrated_p50_s"]
    assert flags[0]["counts"] == {"cuda": 20, "torch": 20}
    # agreeing observations -> no flag; too few observations -> ignored
    agree = KernelPolicy(table={("k", bucket): "torch"}, env_var=None)
    assert calibration_check(policy=agree, registry=reg) == []
    assert calibration_check(policy=pol, registry=reg, min_count=21) == []


def test_default_policy_swap():
    old = dispatch.default_policy()
    mine = KernelPolicy(backend="torch")
    try:
        assert dispatch.set_default_policy(mine) is old
        args = _stump_vote_args()
        ops.stump_vote_batched(*args)
        assert set(mine.choices.values()) == {"torch"}
    finally:
        dispatch.set_default_policy(old)
    assert dispatch.default_policy() is old


# -------------------------------------- serving evaluator re-resolution fix

def test_evaluator_reresolves_backend_per_call(monkeypatch):
    """A policy/env change after construction steers the very next
    evaluate(); both backends serve the reference's margin."""
    from repro_torch.serve import EnsembleRegistry
    from repro_torch.serve.batching import Request
    from repro_torch.serve.engine import BatchEvaluator
    rng = np.random.RandomState(0)
    reg = EnsembleRegistry()
    params = np.zeros((4, 4), np.float32)
    params[:, 0] = rng.randint(0, 6, size=4)
    params[:, 1] = rng.randn(4)
    params[:, 2] = 1.0
    reg.publish_packed("t", torch.from_numpy(params),
                       torch.ones((4,), dtype=torch.float32), clock=0.0)
    pol = KernelPolicy()
    ev = BatchEvaluator(reg, policy=pol, device="cpu")
    x = rng.randn(6).astype(np.float32)
    batch = [Request(rid=0, tenant="t", x=x, t_submit=0.0)]
    r1 = ev.evaluate(batch)
    (bucket,) = [b for (k, b) in pol.choices if k == "stump_vote_batched"]
    assert pol.choices[("stump_vote_batched", bucket)] == \
        platform_default("cpu")
    monkeypatch.setenv(ENV_VAR, "cuda")
    with pytest.warns(RuntimeWarning):
        r2 = ev.evaluate(batch)
    assert pol.choices[("stump_vote_batched", bucket)] == "torch"
    want = float(np.asarray(jref.stump_vote_batched_ref(
        jnp.asarray(x[params[:, 0].astype(int)][None, :, None]),
        jnp.asarray(params[None, :, 1]), jnp.asarray(params[None, :, 2]),
        jnp.ones((1, 4), jnp.float32)))[0, 0])
    assert r1[0].margin == pytest.approx(want, abs=1e-5)
    assert r2[0].margin == r1[0].margin



# ------------------------------------------ the engine's kernel policy

@pytest.mark.parametrize("fleet", [False, True])
def test_engine_kernel_policy_drives_its_stump_scans(fleet):
    """``FederatedBoostEngine(kernel_policy=)`` routes the single fits'
    scans and the fleet's batched ones through that policy (bound into the
    spec it builds); an explicit ``weak`` spec keeps its own fits.  (The
    JAX package resolves the name through its policy and records the
    choice in the default one, so its choices are not compared.)"""
    import dataclasses
    from repro_torch.configs.paper_fedboost import FedBoostConfig
    from repro_torch.core import FederatedBoostEngine
    from repro_torch.data import make_domain_data
    from repro_torch.models import weak
    from repro_torch.sim.scenarios import DOMAINS
    dom = dataclasses.replace(DOMAINS["iot"], n_samples=240, n_clients=4)
    data = make_domain_data(dom, seed=0)
    cfg = FedBoostConfig(n_clients=4, n_rounds=2, seed=0)
    kernel = "stump_scan_batched" if fleet else "stump_scan"
    for spec in (None, weak.get_weak_learner("stump")):
        pol = KernelPolicy(backend="torch", env_var=None)
        FederatedBoostEngine(cfg, data, "enhanced", weak=spec, fleet=fleet,
                             kernel_policy=pol, device="cpu").run()
        if spec is None:
            assert {k for k, _ in pol.choices} == {kernel}
            assert set(pol.choices.values()) == {"torch"}
        else:
            assert pol.choices == {}
