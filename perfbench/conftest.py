import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# the cells' configurations cut to a size the CPU runs in a second
SMALL = {"covtype_10p": {"n_samples": 2400, "rows_per_client": 180,
                         "val_rows_per_client": 60}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skipped where there is none")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")


@pytest.fixture
def small_bench(tmp_path):
    """(spec, bench_dir): the benchmark with its configurations cut to
    SMALL, in a copy of this folder."""
    bench = tmp_path / "perfbench"
    shutil.copytree(HERE, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "test_*.py"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        path = tmp_path / c["file"]
        conf = json.loads(path.read_text())
        conf.update(SMALL[c["name"]])
        path.write_text(json.dumps(conf))
    return spec, bench
