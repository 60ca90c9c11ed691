"""The port's ``serve_ensemble`` launcher against the JAX package's, on the
CPU at a small cut: edge_vision and iot trained 3 rounds (enhanced, at
most 2,000 samples and 8 clients each) into a 2-host sharded cluster, then
0.5 s of bursty arrivals with the first tenant's owner killed mid-serve,
the autoscaler on (up to 4 hosts) and a policy table (a host override, an
iot entry on the fused fingerprint path with its own budget and cap, an
edge_vision@host-0 pair cap).

Three runs: the reference's; the port in lockstep, handed the reference's
stump at every fit, whose report and printed lines must equal the
reference's field for field; and the port on its own through ``main``
(with its trace and metrics written), whose report must equal the
reference's in every field but the snapshot versions and staleness (an
enhanced run may split at an exact stump tie, ROADMAP C4).  The reference
runs on its XLA backend (``REPRO_KERNEL_BACKEND=xla``), which its CI uses
and which reads nothing the port reads."""
import contextlib
import io
import json
import math
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import serve_ensemble as jse  # noqa: E402
from repro.models import weak as jweak  # noqa: E402
from repro_torch.kernels.dispatch import ENV_VAR  # noqa: E402
from repro_torch.obs import load_trace  # noqa: E402
from repro_torch.launch import obs_report  # noqa: E402
from repro_torch.launch import serve_ensemble as pse  # noqa: E402
from repro_torch.models import weak  # noqa: E402

DOMAINS = ["edge_vision", "iot"]
ROUNDS, SEED, RATE, DURATION, HOSTS, AUTOSCALE = 3, 0, 400.0, 0.5, 2, 4
TABLE = {"default": {"max_batch": 32},
         "hosts": {"host-1": {"batch": {"queue_budget": 512}}},
         "tenants": {"iot": {"batch": {"queue_budget": 64, "max_batch": 8},
                             "kernel": {"fused_fingerprint": True}}},
         "pairs": {"edge_vision@host-0": {"batch": {"max_batch": 16}}}}
# fields that follow the trained snapshots (C4), not the arrivals
TRAINED = ("snapshot_version", "mean_staleness_s")


def _key(p):
    return (int(np.asarray(p["feature"])), float(np.asarray(p["threshold"])),
            float(np.asarray(p["polarity"])))


def _engine_with(module, make_weak):
    """A stand-in for ``module.FederatedBoostEngine`` that hands every
    engine the weak learner spec ``make_weak()`` builds."""
    real = module.FederatedBoostEngine
    return lambda *args, **kw: real(*args, weak=make_weak(), **kw)


def _argv(table_path):
    return ["--domains", *DOMAINS, "--rounds", str(ROUNDS), "--rate",
            str(RATE), "--duration", str(DURATION), "--hosts", str(HOSTS),
            "--seed", str(SEED), "--kill-owner", "--autoscale",
            str(AUTOSCALE), "--policy-table", str(table_path)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve_ensemble")
    table_path = tmp / "table.json"
    table_path.write_text(json.dumps(TABLE))
    argv = _argv(table_path)
    fits = []

    def recording():
        base = jweak.get_weak_learner("stump")

        def fit(x, y, w, key):
            p = base.fit(x, y, w, key)
            fits.append(_key(p))
            return p
        return jweak.WeakLearnerSpec("stump", fit, base.predict,
                                     base.param_bytes)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_KERNEL_BACKEND", "xla")
        mp.delenv(ENV_VAR, raising=False)
        mp.setattr(jse, "FederatedBoostEngine", _engine_with(jse, recording))
        servers = []
        real_serve = jse.serve
        mp.setattr(jse, "serve", lambda *a, **kw: servers.append(
            real_serve(*a, **kw)) or servers[-1])
        mp.setattr(sys, "argv", ["serve_ensemble", *argv])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            jse.main()
        out["ref"] = (servers[-1].report(), buf.getvalue())

        replay = iter(list(fits))

        def lockstep():
            base = weak.get_weak_learner("stump")

            def fit(x, y, w, generator=None):
                f, th, pol = next(replay)
                return {"feature": torch.tensor(f, dtype=torch.int32),
                        "threshold": torch.tensor(th, dtype=torch.float32),
                        "polarity": torch.tensor(pol, dtype=torch.float32)}
            return weak.WeakLearnerSpec("stump", fit, base.predict,
                                        base.param_bytes)

        mp.setattr(pse, "FederatedBoostEngine", _engine_with(pse, lockstep))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rep = pse.main([*argv, "--device", "cpu"])
        assert next(replay, None) is None, "the port fit fewer times"
        out["lock"] = (rep, buf.getvalue())

    trace, metrics = tmp / "trace.jsonl", tmp / "metrics.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rep = pse.main([*argv, "--trace", str(trace), "--metrics",
                        str(metrics), "--device", "cpu"])
    out["own"] = (rep, buf.getvalue())
    out["files"] = (trace, metrics)
    return out


def _diff(got, want, path="", skip=()):
    """Paths where two reports differ (floats to 1e-9 relative)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        return [d for k in want if k not in skip
                for d in _diff(got[k], want[k], f"{path}.{k}", skip)]
    if isinstance(want, float):
        same = math.isclose(got, want, rel_tol=1e-9, abs_tol=1e-12)
        return [] if same else [f"{path}: {got!r} != {want!r}"]
    return [] if got == want else [f"{path}: {got!r} != {want!r}"]


def test_lockstep_report_and_lines_equal_the_references(runs):
    (rep, lines), (jrep, jlines) = runs["lock"], runs["ref"]
    assert _diff(rep, jrep) == []
    assert lines == jlines
    assert jrep["completed"] > 200 and jrep["rejected"] == 0
    assert "retired" in {h["status"] for h in jrep["per_host"].values()}
    assert "marked host-" in jlines and "autoscaler:" in jlines


def test_own_run_report_equals_the_references_but_for_trained_fields(runs):
    (rep, lines), (jrep, jlines) = runs["own"], runs["ref"]
    assert _diff(rep, jrep, skip=TRAINED) == []
    # every line but the trained tenants' and the files written
    keep = lambda text: [  # noqa: E731
        ln for ln in text.splitlines()
        if not ln.startswith(("trained ", "  tenant ", "  trace: ",
                              "  metrics: ", "loaded policy"))]
    assert keep(lines) == keep(jlines)
    for name in DOMAINS:
        assert rep["tenants"][name]["snapshot_version"] >= 1


def test_own_run_writes_a_clean_trace_and_kernel_profile(runs):
    trace, metrics = runs["files"]
    meta, spans = load_trace(str(trace))
    assert obs_report.check_trace(spans, meta) == []
    snap = json.loads(metrics.read_text())
    rows, _ = obs_report.kernel_profile(snap)
    kernels = {(r["kernel"], r["backend"]) for r in rows}
    # on the CPU every dispatched call took the plain version
    assert {("stump_scan", "torch"), ("stump_vote_batched", "torch"),
            ("stump_vote_fp_batched", "torch")} <= kernels
    assert {b for _, b in kernels} == {"torch"}
