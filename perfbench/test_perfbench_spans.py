"""The span metrics on the CPU: a traced run prints the host ones beside
every per-layer metric a CPU run printed before, and only its traced
federations record spans."""
import time

import pytest

from perfbench import harness

# what a CPU run of the sync1 cell printed before: its per-layer metrics
# move the card's busy rate there, as ``<base>.busy`` (``mfu.busy`` reads
# the card's busy time, which a CPU run has none of), beside the host rate
BEFORE = {"sync_slot_use", "wall_client_rounds_per_s"}
HOST = {"dispatch_us", "round_host_ms", "sync_host_ms", "sync_wait_ms"}


@pytest.fixture
def profiled():
    """The program's profiled tracer, emptied before the run."""
    from repro_torch import obs
    obs.disable()
    if obs.profiled_tracer() is not None:
        obs.profiled_tracer().clear()
    return obs


def test_traced_run_prints_the_span_metrics(small_bench, profiled,
                                            monkeypatch):
    spec, bench = small_bench
    monkeypatch.setattr(harness, "TRACED_FEDERATIONS", 1)
    r = harness.run(spec, "covtype10p_sync1", 2**31 + 11, 0.3, True, "cpu",
                    time.perf_counter(), bench_dir=bench)
    line = r["line"]
    assert line["correct"], line["checks"]
    base = {k.split(".")[0] for k in line["metrics"]}
    assert base == BEFORE | HOST                     # no sync_gather_ms
    m = {k.split(".")[0]: v["value"] for k, v in line["metrics"].items()}
    assert m["dispatch_us"] > 0 and m["sync_wait_ms"] >= 0
    assert 0 < m["sync_host_ms"] and 0 < m["round_host_ms"]
    assert line["metrics"]["dispatch_us.busy"]["unit"] == "us"
    # the traced federation's steps, and none of the window's
    steps = [d for d in profiled.profiled_tracer().finished()
             if d["name"] == "fed_mesh.step"]
    assert len(steps) == len(r["context"]["traced"]["steps"])


def test_untraced_run_records_no_span(small_bench, profiled):
    spec, bench = small_bench
    r = harness.run(spec, "covtype10p_enhanced", 2**31 + 12, 0.3, False,
                    "cpu", time.perf_counter(), bench_dir=bench)
    assert r["line"]["correct"], r["line"]["checks"]
    assert not len(profiled.profiled_tracer() or ())
