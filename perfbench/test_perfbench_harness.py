"""The harness on the CPU: discovery by name, its refusals, what it loads,
and broken timed paths coming out not correct."""
import json
import shutil
import subprocess
import sys
import time

import pytest

from perfbench import faults, harness

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
@pytest.mark.parametrize("workload", ["covtype10p_enhanced",
                                      "covtype10p_enhanced",
                                      "covtype10p_sync1"])
def test_each_cell_runs_correct_on_the_card(card, workload):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", workload,
         "--seed", "3000000001", "--seconds", "3", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
