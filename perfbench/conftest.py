import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def cpu_cut(bench: Path, config: str) -> Path:
    """The file of a configuration's CPU cut: the keys of its configuration
    that the CPU tests set, to run it in a second."""
    return bench / "cpu_cut" / f"{config}.json"


def apply_cpu_cuts(spec, bench: Path) -> None:
    """Each configuration's file under ``bench``, with the keys of its cut
    over it where it has one; one without a cut is left as it is."""
    for c in spec["configs"]:
        cut = cpu_cut(bench, c["name"])
        if cut.is_file():
            path = bench.parent / c["file"]
            conf = json.loads(path.read_text())
            conf.update(json.loads(cut.read_text()))
            path.write_text(json.dumps(conf))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skipped where there is none")


def pytest_generate_tests(metafunc):
    """A test that takes ``workload`` runs once for each cell of
    ``BENCHMARK.json``, one that takes ``configuration`` once for each
    configuration."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for arg, key in (("workload", "workloads"), ("configuration", "configs")):
        if arg in metafunc.fixturenames:
            metafunc.parametrize(arg, [e["name"] for e in spec[key]])


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


@pytest.fixture
def small_bench(tmp_path):
    """(spec, bench_dir): the benchmark with its configurations cut to
    their ``cpu_cut`` files, in a copy of this folder."""
    bench = tmp_path / "perfbench"
    shutil.copytree(HERE, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "test_*.py"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    apply_cpu_cuts(spec, bench)
    return spec, bench
