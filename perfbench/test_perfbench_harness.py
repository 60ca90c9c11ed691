"""The harness on the CPU: discovery by name, its refusals, what it loads,
broken timed paths coming out not correct, and a configuration added as
files alone running through every per-cell test."""
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time
import xml.etree.ElementTree as ET

import pytest

from perfbench import faults, harness
from perfbench.conftest import cpu_cut
from perfbench.traffic.generator import mesh_inputs

ROOT = harness.ROOT
RUN = ["perfbench/run.py", "--workload", "covtype10p_enhanced",
       "--seed", "3000000000", "--seconds", "1", "--trace", "0"]


def test_discovery_finds_a_configuration_mix_and_metric_added_as_files(
        small_bench, monkeypatch):
    spec, bench = small_bench
    monkeypatch.setattr(harness, "TRACED_FEDERATIONS", 1)
    conf = json.loads((bench / "configs/covtype_10p.json").read_text())
    (bench / "configs/added.json").write_text(json.dumps(conf))
    (bench / "traffic/added_mix.json").write_text(json.dumps(
        {"n_rounds": 12, "buffer_cap": 8}))
    (bench / "metrics/added_metric.py").write_text(
        "def read(ctx):\n    return 42.0 + ctx['rounds'] * 0\n")
    (bench / "end_to_end/added_rate.py").write_text(
        "def read(ctx):\n    return 2.0 * ctx['rounds']\n")
    (bench / "limits/added_cell.json").write_text(
        (bench / "limits/covtype10p_enhanced.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="added",
                                file="perfbench/configs/added.json"))
    spec["workloads"].append({"name": "added_cell", "config": "added",
                              "traffic": "added_mix", "chips": 1,
                              "why": "added"})
    spec["per_layer"].append({"name": "added_metric", "unit": "%",
                              "better": "higher", "source": "host_clock",
                              "layer": "whole round",
                              "moves": "client_rounds_per_s",
                              "workloads": ["added_cell"]})
    spec["end_to_end"].append({"name": "added_rate", "unit": "rounds",
                               "better": "higher", "bound": 0.05,
                               "source": "host_clock",
                               "workloads": ["added_cell"]})
    c = harness.cell(spec, "added_cell", bench)
    assert c["traffic"]["n_rounds"] == 12
    assert "added_metric" in c["readers"]
    assert "added_rate" in c["e2e_readers"]
    r = harness.run(spec, "added_cell", 1, 0.5, True, "cpu",
                    time.perf_counter(), bench_dir=bench)
    assert r["line"]["metrics"]["added_metric"]["value"] == 42.0
    assert r["line"]["correct"], r["line"]["checks"]
    r = harness.run(spec, "added_cell", 1, 0.5, False, "cpu",
                    time.perf_counter(), bench_dir=bench)
    rate = r["line"]["metrics"]["added_rate"]["value"]
    assert rate == 2.0 * r["line"]["attempted"]
    other = harness.cell(spec, "covtype10p_enhanced", bench)
    assert "added_metric" not in other["readers"]
    assert "added_rate" not in other["e2e_readers"]


def test_a_metric_without_workloads_goes_where_what_it_moves_is_reported(
        small_bench):
    spec, bench = small_bench
    (bench / "metrics/plain.py").write_text("def read(ctx):\n    return 1.0\n")
    for name, moves in (("plain", "client_rounds_per_s"),
                        ("plain.busy", "busy_client_rounds_per_s")):
        spec["per_layer"].append({"name": name, "unit": "%",
                                  "better": "higher", "source": "host_clock",
                                  "layer": "whole round", "moves": moves})
    cells = {w: harness.cell(spec, w, bench)
             for w in ("covtype10p_enhanced", "covtype10p_sync1")}
    rates = {w: {m["name"] for m in c["end_to_end"]}
             for w, c in cells.items()}
    for w, c in cells.items():
        # every cell's per-layer metric moves one of that cell's rates
        assert {m["moves"] for m in c["per_layer"]} <= rates[w]
        assert ("plain" in c["readers"]) is ("client_rounds_per_s"
                                              in rates[w])
        # ``plain.busy`` has no file of its own: ``plain.py`` reads it
        assert c["readers"]["plain.busy"]({}) == 1.0
    assert "client_rounds_per_s" not in rates["covtype10p_sync1"]


def test_every_per_layer_metric_moves_a_rate_of_its_cell(workload):
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    c = harness.cell(spec, workload)
    rates = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in rates and len(rates) >= 2 and c["per_layer"]
    assert {m["moves"] for m in c["per_layer"]} <= rates


def test_the_busy_rate_and_its_mfu_read_the_traced_federations():
    from perfbench import cost
    busy = harness.reader("end_to_end", "busy_client_rounds_per_s")
    mfu = harness.reader("metrics", "mfu.busy")
    shape = dict(K=10, n=100, nv=20, F=6, T=16, cap=1)
    steps = [(True, 1)] * 3 + [(False, 0)]
    ctx = {"shape": shape, "traced": {"steps": steps, "busy_s": 0.002,
                                      "misses": 0}}
    assert busy(ctx) == pytest.approx(10 * 4 / 0.002)
    least = (4 * cost.local_round(10, 100, 6, 16, 0)
             + 3 * cost.sync(10, 100, 20, 6, 10))
    assert mfu(ctx) == pytest.approx(100 * least / 0.002)
    # nothing to read: no traced federations, or no device operation
    for empty in ({"shape": shape},
                  {"shape": shape, "traced": dict(ctx["traced"], busy_s=0)}):
        assert busy(empty) is None and mfu(empty) is None


def test_read_trace_takes_the_union_of_the_device_operations():
    import torch
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    class Ev:
        def __init__(self, name, dev, a, b, note=False):
            self.name = lambda: name
            self.device_type = lambda: dev
            self.start_ns, self.end_ns = lambda: a, lambda: b
            self.is_user_annotation = lambda: note

    evs = [Ev("outer", cpu, 0, 10_000), Ev("inner", cpu, 4_000, 6_000),
           Ev("k1", cuda, 1_000, 3_000), Ev("k2", cuda, 2_000, 4_000),
           Ev("k1", cuda, 8_000, 9_000),
           Ev("span", cuda, 0, 10_000, note=True),      # no operation
           Ev("[memory]", cpu, 5_000, 5_000)]           # filtered out
    prof = type("P", (), {})()
    prof.profiler = type("R", (), {})()
    prof.profiler.kineto_results = type("K", (), {"events": lambda s: evs})()
    out = harness.read_trace(prof)
    assert out["busy_s"] == pytest.approx(4e-6)        # 1-4 us and 8-9 us
    assert out["device_ops"] == {"k1": [pytest.approx(3e-6), 2],
                                 "k2": [pytest.approx(2e-6), 1]}
    # the gap 4-8 us is named by the innermost host event at its middle
    assert out["breakdown"]["idle_gaps"] == [["inner", pytest.approx(4e-6)]]
    assert out["breakdown"]["device_ops"][0][0] == "k1"


def test_every_configuration_has_a_cpu_cut(configuration):
    spec = harness.load_json(ROOT / "BENCHMARK.json")
    c = {c["name"]: c for c in spec["configs"]}[configuration]
    cut = cpu_cut(harness.HERE, configuration)
    assert cut.is_file(), \
        f"{configuration} has no CPU cut: {cut.relative_to(ROOT)}"
    conf = {**harness.load_json(ROOT / c["file"]), **harness.load_json(cut)}
    x, _, xv, _ = mesh_inputs(conf, 2**31 + 13)
    K, F = conf["n_clients"], conf["n_features"]
    assert x.shape == (K, conf["rows_per_client"], F)
    assert xv.shape == (K, conf["val_rows_per_client"], F)


def test_each_cell_runs_correct_on_the_cpu(small_bench, workload):
    spec, bench = small_bench
    r = harness.run(spec, workload, 2**31 + 17, 0.3, False, "cpu",
                    time.perf_counter(), bench_dir=bench)
    line = r["line"]
    assert line["correct"], line["checks"]
    # every end-to-end metric but those read from the card's trace, which a
    # CPU run has none of
    assert set(line["metrics"]) == {
        m["name"] for m in harness.cell(spec, workload, bench)["end_to_end"]
        if m["source"] != "device_trace"}


def _checkout(tmp_path):
    """The root of a copy of the benchmark, its tests with it, beside the
    program's sources."""
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", root)
    (root / "src").symlink_to(ROOT / "src")
    return root


def _digests(folder):
    return {p.relative_to(folder): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file()}


def _add_configuration(root, name, conf, traffic, cut=None):
    """``name`` and its cell ``<name>_<traffic>`` as new files and new
    entries of the copy's BENCHMARK.json alone; returns the cell's name."""
    bench, workload = root / "perfbench", f"{name}_{traffic}"
    (bench / "configs" / f"{name}.json").write_text(json.dumps(conf))
    if cut is not None:
        cpu_cut(bench, name).write_text(json.dumps(cut))
    (bench / "limits" / f"{workload}.json").write_text(
        (bench / "limits" / f"covtype10p_{traffic}.json").read_text())
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name=name,
                                file=f"perfbench/configs/{name}.json",
                                reduced=[]))
    spec["workloads"].append({"name": workload, "config": name,
                              "traffic": traffic, "chips": 1,
                              "why": "added as files"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=2))
    return workload


def _pytest(root, tmp_path, select):
    """The copy's own tests that ``select`` picks, run in a process of
    their own; {test name: outcome, failure message}."""
    report = tmp_path / "report.xml"
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("PYTEST_")}       # no outer run's workers
    env.update(PYTHONPATH=str(root / "src"), PYTHONDONTWRITEBYTECODE="1")
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-k", select, f"--basetemp={tmp_path / 'basetemp'}",
         f"--junitxml={report}", "perfbench"],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    assert report.is_file(), out.stdout[-2000:] + out.stderr[-2000:]
    got = {}
    for case in ET.parse(report).iter("testcase"):
        bad = [e for e in case if e.tag in ("failure", "error", "skipped")]
        got[case.get("name")] = ((bad[0].tag, bad[0].get("message", ""))
                                 if bad else ("passed", ""))
    return got


def test_a_configuration_added_as_files_runs_through_the_per_cell_tests(
        tmp_path):
    root = _checkout(tmp_path)
    before = _digests(root / "perfbench")
    # a federation of its own shape: more clients, fewer features, iid
    # shards of 1,000 rows; the cut takes its clients, rows and samples
    base = harness.load_json(root / "perfbench/configs/covtype_10p.json")
    conf = dict(base, domain="extra", n_samples=50000,
                n_features=20, n_clients=40, val_frac=0.2,
                rows_per_client=1000, val_rows_per_client=250)
    cut = {"n_clients": 12, "n_samples": 1500, "rows_per_client": 100,
           "val_rows_per_client": 25}
    workload = _add_configuration(root, "extra_conf", conf, "enhanced", cut)
    got = _pytest(root, tmp_path, "extra_conf")
    per_cell = ("test_reference_agrees_with_the_mesh_step_over_a_federation",
                "test_the_bf16_control_fails_the_cells_limits",
                "test_each_cell_runs_correct_on_the_cpu",
                "test_every_per_layer_metric_moves_a_rate_of_its_cell")
    want = {f"{t}[{workload}]": ("passed", "") for t in per_cell}
    want["test_every_configuration_has_a_cpu_cut[extra_conf]"] = (
        "passed", "")
    want[f"test_each_cell_runs_correct_on_the_card[{workload}]"] = (
        "skipped", "no CUDA card")
    assert got == want
    assert _digests(root / "perfbench").items() >= before.items()


def test_a_configuration_without_a_cut_fails_only_the_cut_test(tmp_path):
    root = _checkout(tmp_path)
    # small as it stands, so its per-cell tests run uncut
    base = harness.load_json(root / "perfbench/configs/covtype_10p.json")
    conf = dict(base, n_samples=1200, n_clients=8, val_frac=0.2,
                rows_per_client=120, val_rows_per_client=30)
    workload = _add_configuration(root, "bare_conf", conf, "sync1")
    got = _pytest(root, tmp_path,
                  "bare_conf or (broken_timed_path and unchanged)")
    failed = {k: v[1] for k, v in got.items() if v[0] in ("failure", "error")}
    assert list(failed) == ["test_every_configuration_has_a_cpu_cut"
                            "[bare_conf]"]
    assert "perfbench/cpu_cut/bare_conf.json" in list(failed.values())[0]
    passed = {k for k, v in got.items() if v[0] == "passed"}
    assert passed >= {
        "test_a_broken_timed_path_comes_out_not_correct[unchanged]",
        f"test_each_cell_runs_correct_on_the_cpu[{workload}]",
        f"test_reference_agrees_with_the_mesh_step_over_a_federation"
        f"[{workload}]"}


def test_no_card_no_result():
    out = subprocess.run([sys.executable, *RUN], cwd=ROOT,
                         capture_output=True, text=True,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_only_the_benchmark_files_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, *RUN], cwd=tmp_path,
                         capture_output=True, text=True)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_harness_loads_no_jax_nor_the_jax_package(small_bench):
    _, bench = small_bench
    code = f"""
import sys, json, time
sys.path.insert(0, {str(ROOT)!r})
from pathlib import Path
from perfbench import harness
harness.TRACED_FEDERATIONS = 1
spec = json.loads(Path({str(ROOT / 'BENCHMARK.json')!r}).read_text())
r = harness.run(spec, "covtype10p_enhanced", 1, 0.3, True, "cpu",
                time.perf_counter(), bench_dir=Path({str(bench)!r}))
assert r["line"]["correct"], r["line"]
print(harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("fault", (None,) + faults.FAULTS)
def test_a_broken_timed_path_comes_out_not_correct(small_bench, fault):
    spec, bench = small_bench
    with faults.planted(fault) if fault else _nothing() as wrap:
        r = harness.run(spec, "covtype10p_enhanced", 2**31 + 3, 0.5,
                        False, "cpu", time.perf_counter(), bench_dir=bench,
                        fault=wrap)
    line = r["line"]
    assert line["correct"] is (fault is None), line["checks"]
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {"client_rounds_per_s", "setup_s"}


class _nothing:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


@pytest.mark.cuda
def test_each_cell_runs_correct_on_the_card(card, workload):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", workload,
         "--seed", "3000000001", "--seconds", "3", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
