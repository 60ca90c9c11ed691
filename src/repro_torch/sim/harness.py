"""Scenario harness, train half: one registered scenario end to end —
train both engine modes through a behavior trace on the engine's device,
then check the result against the scenario's paper band.

Training drives :class:`~repro_torch.core.async_engine.FederatedBoostEngine`
(baseline and enhanced) with the scenario's ``behavior_for`` hook; the
scenario's ``fleet`` field picks the engine profile, so ``mobile_100k``
runs the vectorized fleet profile.  One :class:`ScenarioReport` per
(scenario, trace, seed) carries the result.

The serve replay (the request trace derived from the behavior models,
played into an autoscaled sharded fleet) needs ``serve/shard.py``,
``serve/autoscale.py`` and ``obs/slo.py``, and the chain scenario needs
``chain/*``; none is ported, so :func:`run_scenario` refuses to serve a
scenario that replays serving (``serve_replay=True``) instead of skipping
the replay.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from repro_torch import obs
from repro_torch.core import FederatedBoostEngine
from repro_torch.core.async_engine import RunMetrics
from repro_torch.core.metrics import (
    common_target, pct_reduction, time_to_error)
from repro_torch.sim.scenarios import Scenario, get_scenario

UNPORTED_SERVE = ("the scenario serve replay needs serve/shard.py, "
                  "serve/autoscale.py and obs/slo.py (and chain/* for a "
                  "chain scenario), which are not ported yet; run with "
                  "serve=False (--no-serve) to train and band-check only")


@dataclass
class ScenarioReport:
    """Train results for one (scenario, trace, seed)."""
    scenario: str
    trace: str
    seed: int
    baseline: RunMetrics
    enhanced: RunMetrics
    row: Dict[str, float]            # Table-1-style relative improvements
    band_failures: List[str]         # empty = within paper band

    @property
    def within_band(self) -> bool:
        return not self.band_failures


def train_pair(sc: Scenario, trace: str, seed: int = 0,
               n_rounds: Optional[int] = None, engine: str = "events",
               device="cuda") -> Tuple[Dict, Dict[str, RunMetrics]]:
    """Run baseline + enhanced through one behavior trace on one dataset.
    ``engine`` selects the execution core (``events``, the default, or the
    legacy ``loop`` parity oracle); the scenario's ``fleet`` field picks
    the engine profile (None = auto by fleet size)."""
    data = sc.make_data(seed)
    cfg = sc.fedboost_config(seed=seed, n_rounds=n_rounds)
    runs: Dict[str, RunMetrics] = {}
    for mode in ("baseline", "enhanced"):
        # a fresh behavior set per engine: stateful models (Gilbert
        # chains, outage processes) must not leak state across runs
        eng = FederatedBoostEngine(cfg, data, mode,
                                   behavior_for=sc.behavior_for(trace, seed),
                                   engine=engine, fleet=sc.fleet,
                                   device=device)
        with obs.span("scenario.train", sim_t=0.0, scenario=sc.name,
                      trace=trace, seed=seed, mode=mode) as sp:
            runs[mode] = eng.run()
            sp.end_sim(runs[mode].sim_time_s)
    return data, runs


def result_row(runs: Dict[str, RunMetrics]) -> Dict[str, float]:
    """The Table-1 relative-improvement row for one baseline/enhanced pair
    (the JAX package's metric definitions)."""
    b, e = runs["baseline"], runs["enhanced"]
    tgt = common_target([b.val_error_curve, e.val_error_curve])
    tb = time_to_error(b.val_error_curve, tgt)
    te = time_to_error(e.val_error_curve, tgt)
    return {
        "time_down": pct_reduction(tb[0], te[0]) if tb and te else 0.0,
        "comm_down": pct_reduction(b.total_bytes, e.total_bytes),
        "msgs_down": pct_reduction(b.n_messages, e.n_messages),
        "conv_down": pct_reduction(tb[1], te[1]) if tb and te else 0.0,
        "acc_delta_pp": 100.0 * (b.final_test_error - e.final_test_error),
        "base_err": b.final_test_error,
        "enh_err": e.final_test_error,
        "base_bytes": float(b.total_bytes),
        "enh_bytes": float(e.total_bytes),
        "unavailable_rounds": float(e.rounds_unavailable),
    }


def run_scenario(name_or_scenario, trace: str = "legacy", seed: int = 0,
                 n_rounds: Optional[int] = None, serve: bool = True,
                 engine: str = "events", device="cuda") -> ScenarioReport:
    """One scenario end to end: train both modes through ``trace`` on
    ``device`` and check the paper band.  Scenarios with
    ``serve_replay=False`` (the fleet-scale smokes) skip the serve phase,
    as in the JAX package; for any other scenario ``serve=True`` raises
    :class:`NotImplementedError`, because the replay is not ported."""
    sc = (name_or_scenario if isinstance(name_or_scenario, Scenario)
          else get_scenario(name_or_scenario))
    if serve and sc.serve_replay:
        raise NotImplementedError(f"scenario {sc.name!r}: {UNPORTED_SERVE}")
    with obs.span("scenario.run", scenario=sc.name, trace=trace, seed=seed):
        _, runs = train_pair(sc, trace, seed=seed, n_rounds=n_rounds,
                             engine=engine, device=device)
        row = result_row(runs)
        report = ScenarioReport(
            scenario=sc.name, trace=trace, seed=seed,
            baseline=runs["baseline"], enhanced=runs["enhanced"],
            row=row, band_failures=sc.band.check(row))
    return report


def summarize(rep: ScenarioReport) -> str:
    """Human-readable one-scenario summary (the run_scenario CLI output)."""
    sc = get_scenario(rep.scenario)
    return "\n".join([
        f"scenario {rep.scenario} · trace {rep.trace} · seed {rep.seed}",
        f"  train: time_down {rep.row['time_down']:+.1f}%  "
        f"comm_down {rep.row['comm_down']:+.1f}%  "
        f"msgs_down {rep.row['msgs_down']:+.1f}%  "
        f"acc_delta {rep.row['acc_delta_pp']:+.1f}pp  "
        f"(unavailable rounds: {rep.row['unavailable_rounds']:.0f})",
        f"  band:  time ~{sc.band.time_down[0]:.0f}-"
        f"{sc.band.time_down[1]:.0f}%  comm ~{sc.band.comm_down[0]:.0f}-"
        f"{sc.band.comm_down[1]:.0f}%  acc {sc.band.acc_delta_pp[0]:+.1f}.."
        f"{sc.band.acc_delta_pp[1]:+.1f}pp  -> "
        + ("WITHIN BAND" if rep.within_band
           else "OUT OF BAND: " + "; ".join(rep.band_failures)),
    ])
