"""The port stands alone: no JAX, nothing of the JAX package, and no quiet
fall-back from the card to the CPU."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def test_importing_every_module_loads_neither_jax_nor_repro():
    mods = _port_modules()
    assert {"repro_torch.core.async_engine", "repro_torch.core.fleet",
            "repro_torch.sim.behavior", "repro_torch.sim.traces",
            "repro_torch.sim.scenarios", "repro_torch.sim.harness",
            "repro_torch.launch.run_scenario", "repro_torch.launch.serve",
            "repro_torch.models.transformer",
            "repro_torch.configs.registry", "repro_torch.serve.shard",
            "repro_torch.serve.autoscale", "repro_torch.obs.slo",
            "repro_torch.obs.audit"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_or_repro(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("repro", "jax", "jaxlib"), (path, name)


def test_entry_points_default_to_the_card():
    from repro_torch.configs.paper_fedboost import FedBoostConfig
    from repro_torch.core import FederatedBoostEngine
    from repro_torch.configs.base import reduced
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import Model
    from repro_torch.serve import (BatchEvaluator, EnsembleRegistry,
                                   ShardCluster, ShardedEnsembleServer)
    from repro_torch.sim.harness import run_scenario
    import numpy as np
    x = np.zeros((8, 2), np.float32)
    y = np.ones(8, np.float32)
    data = {"clients": [(x, y)], "val": (x, y), "test": (x, y)}
    cfg = FedBoostConfig(n_clients=1, n_rounds=1)
    lm = reduced(get_arch("qwen1.5-0.5b"))
    if torch.cuda.is_available():
        assert FederatedBoostEngine(cfg, data, "baseline").device.type == "cuda"
        assert BatchEvaluator(EnsembleRegistry()).device.type == "cuda"
        assert ShardedEnsembleServer(ShardCluster(2)).device.type == "cuda"
        assert Model(lm).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="cuda"):
        FederatedBoostEngine(cfg, data, "baseline")
    with pytest.raises(RuntimeError, match="cuda"):
        BatchEvaluator(EnsembleRegistry())
    with pytest.raises(RuntimeError, match="cuda"):
        ShardedEnsembleServer(ShardCluster(2))
    with pytest.raises(RuntimeError, match="cuda"):
        run_scenario("iot", trace="gilbert", n_rounds=1)
    # generate runs on its model's device; the serving CLI's default model
    # is on the card
    with pytest.raises(RuntimeError, match="cuda"):
        Model(lm)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--tokens", "1"])


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run")
    runs = [(ROOT, ROOT / "chip_smoke.py")]
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", lone)
    runs.append((tmp_path, lone))
    for cwd, script in runs:
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
