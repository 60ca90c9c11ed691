"""Recorded behavior traces: first-class JSON trace files under
``artifacts/traces/``.

The scenario registry used to embed its example traces as inline dicts;
real deployments record them (FLGo's phone simulator derives availability
from a mobile-usage pings dataset the same way).  This module is the
bridge: ``load_trace(name)`` reads a checked-in JSON trace for
:meth:`TraceSchedule.from_json`, and ``derive_diurnal_trace`` regenerates
the shipped ``mobile_diurnal`` recording — one reference handset observed
over a 24 s simulated day, sampled from the analytic
:class:`~repro_torch.sim.behavior.DiurnalBehavior` model at a fixed seed so the
artifact is reproducible bit for bit.  The recordings are the repository's
data files, shared with the JAX package; ``write_trace`` records a new one
(under ``REPRO_TRACES_DIR`` when that is set).
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List

import numpy as np

from repro_torch.sim.behavior import DiurnalBehavior

#: Override with REPRO_TRACES_DIR; default is the repo's artifacts dir.
DEFAULT_TRACES_DIR = (Path(__file__).resolve().parents[3]
                      / "artifacts" / "traces")


def traces_dir() -> Path:
    return Path(os.environ.get("REPRO_TRACES_DIR", DEFAULT_TRACES_DIR))


def trace_path(name: str) -> Path:
    return traces_dir() / f"{name}.json"


def available_traces() -> List[str]:
    d = traces_dir()
    return sorted(p.stem for p in d.glob("*.json")) if d.is_dir() else []


def load_trace(name: str) -> Dict:
    """One recorded trace as the dict :meth:`TraceSchedule.from_json`
    accepts (extra metadata keys like ``source`` ride along unharmed)."""
    p = trace_path(name)
    if not p.is_file():
        raise FileNotFoundError(
            f"no recorded trace {name!r} under {traces_dir()} "
            f"(available: {available_traces()})")
    return json.loads(p.read_text())


def derive_diurnal_trace(period_s: float = 24.0, n_segments: int = 48,
                         seed: int = 7, *, peak: float = 0.95,
                         trough: float = 0.3, night_slowdown: float = 1.8,
                         link_mbps: float = 5.0) -> Dict:
    """Record one reference device's day: sample a seeded
    :class:`DiurnalBehavior` every ``period_s / n_segments`` seconds and
    log what a telemetry agent would see — on/off (the Bernoulli
    availability draw, observed not idealized), the compute slowdown, and
    the link bandwidth.  Floats are rounded so the JSON artifact
    round-trips exactly."""
    beh = DiurnalBehavior(1.0, float(period_s), 0.0,
                          np.random.RandomState(seed), peak=peak,
                          trough=trough, night_slowdown=night_slowdown,
                          link_mbps=link_mbps)
    step = float(period_s) / int(n_segments)
    segments = []
    for i in range(int(n_segments)):
        t = i * step
        segments.append({
            "t": round(t, 6),
            "available": bool(beh.availability(t)),
            "speed": round(beh.compute_time(1.0, t), 6),
            "bandwidth_mbps": round(beh.link(t).bandwidth_mbps, 6),
        })
    return {
        "source": (f"derived: DiurnalBehavior(period_s={period_s}, "
                   f"peak={peak}, trough={trough}, "
                   f"night_slowdown={night_slowdown}, seed={seed}) "
                   f"sampled at {n_segments} points over one cycle"),
        "loop_s": float(period_s),
        "segments": segments,
    }


def write_trace(name: str, trace: Dict) -> Path:
    """Write ``trace`` as the recording ``name`` (the JSON that
    :func:`load_trace` reads back); returns its path."""
    p = trace_path(name)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(trace, indent=1) + "\n")
    return p
