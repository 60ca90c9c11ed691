"""The plain reference against the program's mesh step on the CPU, and its
control: the reference in bfloat16 in the program's place."""
import json
import math
import subprocess
import sys

import pytest
import torch

from perfbench import harness
from perfbench.reference.fedboost import control, judge
from perfbench.traffic.generator import mesh_inputs, thresholds

# the cell whose settings the tests of the reference's mechanics borrow;
# the per-cell tests take ``workload``, a case a cell (conftest.py)
SETTINGS_OF = "covtype10p_enhanced"


def federation(spec, bench, workload, seed):
    """The program's states over one federation of the cut cell, and its
    inputs, settings and limits."""
    from repro_torch.configs.paper_fedboost import (
        CompensationConfig, FedBoostConfig, SchedulerConfig)
    from repro_torch.core import fed_mesh
    from repro_torch.kernels.dispatch import KernelPolicy
    c = harness.cell(spec, workload, bench)
    st = harness.settings(c["config"], c["traffic"])
    arrays = mesh_inputs(c["config"], seed)
    thr = thresholds(arrays[0], c["config"]["n_thresholds"])
    x, y, xv, yv = (torch.from_numpy(a) for a in arrays)
    K, n, _ = x.shape
    R, cap = st["n_rounds"], st["buffer_cap"]
    cfg = FedBoostConfig(n_clients=K, n_rounds=R,
                         scheduler=SchedulerConfig(**st["scheduler"]),
                         compensation=CompensationConfig(
                             **st["compensation"]))
    step = fed_mesh.make_fed_boost_step(cfg, torch.from_numpy(thr),
                                        policy=KernelPolicy(env_var=None))
    s = fed_mesh.init_state(cfg, K, n, xv.shape[1], cap, K * R,
                            device="cpu")
    states = [s]
    for _ in range(R):
        s = step(s, x, y, xv, yv)
        states.append(s)
    return states, (*arrays, thr), st, c["limits"]


def test_reference_agrees_with_the_mesh_step_over_a_federation(
        small_bench, workload):
    spec, bench = small_bench
    states, inputs, st, _ = federation(spec, bench, workload, 3)
    assert states[-1].sync_count >= 5          # syncs are judged too
    got = judge(harness.record_from_states(states), inputs, st)
    assert got["pick_gap"] == 0.0 and got["alpha_gap"] <= 1e-6
    assert got["count_miss"] == 0 and got["err_rows"] == 0
    assert got["d_gap"] <= 1e-5 and got["margin_gap"] <= 1e-5
    assert got["nonfinite"] == 0 and got["err_vs_chance"] < 1.0


def test_the_bf16_control_fails_the_cells_limits(small_bench, workload):
    spec, bench = small_bench
    c = harness.cell(spec, workload, bench)
    st = harness.settings(c["config"], c["traffic"])
    arrays = mesh_inputs(c["config"], 5)
    inputs = (*arrays, thresholds(arrays[0], c["config"]["n_thresholds"]))
    got = judge(control(inputs, st, st["n_rounds"]), inputs, st)
    assert any(got[k] > c["limits"][k] for k in got), got
    # the f32 control is the program's own precision: it passes
    same = judge(control(inputs, st, st["n_rounds"], torch.float32),
                 inputs, st)
    assert all(same[k] <= c["limits"][k] for k in same), same


def test_a_changed_record_is_found():
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    c = harness.cell(spec, SETTINGS_OF)
    st = harness.settings(c["config"], c["traffic"])
    g = torch.Generator().manual_seed(0)
    K, n, nv, F = 4, 6, 5, 3
    x = torch.randn((K, n, F), generator=g)
    y = torch.where(torch.rand((K, n), generator=g) < 0.5, 1.0, -1.0)
    xv = torch.randn((K, nv, F), generator=g)
    yv = torch.where(torch.rand((K, nv), generator=g) < 0.5, 1.0, -1.0)
    thr = torch.quantile(x.reshape(-1, F), torch.arange(1, 5) / 5,
                         dim=0).T.contiguous()
    inputs = (x, y, xv, yv, thr)
    rec = control(inputs, st, 12, torch.float32)
    assert all(v == 0 for k, v in judge(rec, inputs, st).items()
               if k not in ("d_gap", "err_vs_chance"))
    rec["states"][4]["D"] = rec["states"][4]["D"].flip(1)
    assert judge(rec, inputs, st)["d_gap"] > 0.01
    rec["states"][4]["D"] = rec["states"][4]["D"].flip(1)
    rec["states"][6]["counter"] += 1
    assert judge(rec, inputs, st)["count_miss"] >= 1
    rec["states"][6]["counter"] -= 1


@pytest.mark.parametrize("where", ["D", "val_margin", "prev_err"])
def test_a_non_finite_state_is_found_and_not_matched(where):
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    c = harness.cell(spec, SETTINGS_OF)
    st = harness.settings(c["config"], c["traffic"])
    g = torch.Generator().manual_seed(1)
    K, n, nv, F = 4, 6, 5, 3
    x = torch.randn((K, n, F), generator=g)
    y = torch.where(torch.rand((K, n), generator=g) < 0.5, 1.0, -1.0)
    xv = torch.randn((K, nv, F), generator=g)
    yv = torch.where(torch.rand((K, nv), generator=g) < 0.5, 1.0, -1.0)
    thr = torch.quantile(x.reshape(-1, F), torch.arange(1, 5) / 5,
                         dim=0).T.contiguous()
    inputs = (x, y, xv, yv, thr)
    rec = control(inputs, st, 12, torch.float32)
    assert judge(rec, inputs, st)["nonfinite"] == 0
    s = rec["states"][-1]
    if where == "prev_err":
        s["prev_err"] = math.nan
    else:
        s[where] = s[where].clone()
        s[where][1, 2] = math.nan
    got = judge(rec, inputs, st)
    assert got["nonfinite"] >= 1
    assert got["err_vs_chance"] != got["err_vs_chance"] or \
        got["d_gap"] == math.inf or got["margin_gap"] == math.inf or \
        got["count_miss"] >= 1


def test_the_update_stays_finite_where_its_exponent_passes_f32s_range():
    from perfbench.reference.fedboost import Fed
    g = torch.Generator().manual_seed(2)
    K, n, F = 2, 8, 3
    inputs = (torch.randn((K, n, F), generator=g), torch.ones((K, n)),
              torch.randn((K, 4, F), generator=g), torch.ones((K, 4)),
              torch.zeros((F, 2)))
    spec = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    c = harness.cell(spec, SETTINGS_OF)
    fed = Fed(inputs, harness.settings(c["config"], c["traffic"]))
    D = torch.full((K, n), 1.0 / n)
    v = torch.linspace(-500.0, 500.0, n).expand(K, n)
    w = fed._eq4(D, v)
    assert bool(torch.isfinite(w).all())
    assert float(w[:, -1].min()) == 1.0


def test_reference_loads_nothing_of_the_program_or_jax():
    code = ("import sys; sys.path.insert(0, '.'); "
            "import perfbench.reference.fedboost, perfbench.cost, "
            "perfbench.traffic.generator; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'repro', 'repro_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
