"""Per-client contribution audits: the measurement layer for the
Byzantine track.

Every merge the engines perform is attributed to the contributing client:
the *update magnitude* (absolute compensated vote weight folded into the
ensemble), the *error delta* (validation error before minus after the
merge — positive means the client helped), the *staleness* (sync rounds
between training and merging), and the merge *outcome*.  Stats land in
two places:

* labeled instruments on the metrics registry
  (``audit.update_magnitude{cid}``, ``audit.error_delta{cid}``,
  ``audit.staleness{cid}`` histograms and ``audit.outcomes{cid,outcome}``
  counters), so a metrics snapshot carries the whole per-client picture;
* bounded per-client rolling windows inside :class:`ContributionAudit`,
  from which :meth:`flags` computes **robust z-score outliers** — the
  modified z-score of Iglewicz & Hoaglin, ``0.6745 * (x - median) / MAD``
  over the per-client means, flagging ``|z| > 3.5``.  Median/MAD (not
  mean/std) keeps a single poisoning client from masking itself by
  inflating the spread it is judged against — the property the
  asynchronous-Byzantine literature (Cox & Decouchant) builds detection
  on.

This module only *measures*; it never changes what the engines merge, so
attaching an audit preserves bit-for-bit loop/events parity (the extra
validation-error reads are pure).  The vectorized fleet profile merges
whole windows in one launch without per-client error deltas, so audits
are a non-fleet feature (``FederatedBoostEngine.attach_audit`` refuses).
"""
from __future__ import annotations

import math
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional

import repro_torch.obs as obs

__all__ = ["AuditFlag", "ClientStats", "ContributionAudit"]

# Iglewicz & Hoaglin: |modified z| > 3.5 marks an outlier
Z_THRESHOLD = 3.5
_MAD_SCALE = 0.6745            # normal-consistency constant for the MAD


@dataclass
class AuditFlag:
    """One flagged (client, metric) pair with its robust z-score."""
    cid: int
    metric: str                # "magnitude" | "error_delta" | "staleness"
    z: float
    value: float               # the client's windowed mean
    median: float              # fleet median of windowed means

    def to_dict(self) -> Dict:
        return {"cid": self.cid, "metric": self.metric, "z": self.z,
                "value": self.value, "median": self.median}


class ClientStats:
    """One client's bounded rolling contribution window."""

    __slots__ = ("cid", "merges", "magnitude", "error_delta", "staleness",
                 "outcomes")

    def __init__(self, cid: int, window: int):
        self.cid = cid
        self.merges = 0
        self.magnitude: Deque[float] = deque(maxlen=window)
        self.error_delta: Deque[float] = deque(maxlen=window)
        self.staleness: Deque[float] = deque(maxlen=window)
        self.outcomes: Dict[str, int] = {}

    def mean(self, metric: str) -> float:
        vals = getattr(self, metric)
        return sum(vals) / len(vals) if vals else 0.0

    def summary(self) -> Dict:
        return {"cid": self.cid, "merges": self.merges,
                "mean_magnitude": self.mean("magnitude"),
                "mean_error_delta": self.mean("error_delta"),
                "mean_staleness": self.mean("staleness"),
                "outcomes": dict(self.outcomes)}


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def robust_z(values: Dict[int, float]) -> Dict[int, float]:
    """Modified z-scores over a {cid: value} map.  With MAD == 0 (most
    clients identical) falls back to the mean absolute deviation scaled to
    normal consistency; if that is zero too, every score is 0."""
    if len(values) < 3:
        return {cid: 0.0 for cid in values}
    med = _median(list(values.values()))
    devs = [abs(v - med) for v in values.values()]
    mad = _median(devs)
    if mad > 0.0:
        scale = mad / _MAD_SCALE
    else:
        mean_dev = sum(devs) / len(devs)
        scale = mean_dev * 1.253314  # E|N(0,1)| consistency
    if scale <= 0.0 or not math.isfinite(scale):
        return {cid: 0.0 for cid in values}
    return {cid: (v - med) / scale for cid, v in values.items()}


class ContributionAudit:
    """Rolling per-client contribution stats + robust outlier flags.

    ``registry`` defaults to the process-wide metrics registry at record
    time (so a harness-scoped fresh registry is respected); ``window``
    bounds each client's rolling deques."""

    METRICS = ("magnitude", "error_delta", "staleness")

    def __init__(self, registry=None, window: int = 256,
                 z_threshold: float = Z_THRESHOLD):
        self._registry = registry
        self.window = int(window)
        self.z_threshold = float(z_threshold)
        self.clients: Dict[int, ClientStats] = {}
        self.recorded = 0

    @property
    def registry(self):
        return (self._registry if self._registry is not None
                else obs.get_registry())

    def stats(self, cid: int) -> ClientStats:
        st = self.clients.get(cid)
        if st is None:
            st = self.clients[cid] = ClientStats(cid, self.window)
        return st

    # ------------------------------------------------------------ recording
    def record(self, cid: int, *, magnitude: float, error_delta: float,
               staleness: float, outcome: str = "merged") -> None:
        """Record one merged (or rejected) contribution."""
        st = self.stats(int(cid))
        st.merges += 1
        st.magnitude.append(float(magnitude))
        st.error_delta.append(float(error_delta))
        st.staleness.append(float(staleness))
        st.outcomes[outcome] = st.outcomes.get(outcome, 0) + 1
        self.recorded += 1
        reg = self.registry
        cid_label = str(int(cid))
        reg.histogram("audit.update_magnitude", cid=cid_label).observe(
            float(magnitude))
        reg.histogram("audit.error_delta", cid=cid_label).observe(
            float(error_delta))
        reg.histogram("audit.staleness", cid=cid_label).observe(
            float(staleness))
        reg.counter("audit.outcomes", cid=cid_label, outcome=outcome).inc()

    # -------------------------------------------------------------- reading
    def flags(self, metric: Optional[str] = None) -> List[AuditFlag]:
        """Outlier flags across clients: for each audited metric, robust
        z-scores of the per-client windowed means, flagging
        ``|z| > z_threshold``.  ``metric`` restricts to one metric."""
        metrics = (metric,) if metric is not None else self.METRICS
        out: List[AuditFlag] = []
        for m in metrics:
            values = {cid: st.mean(m) for cid, st in self.clients.items()
                      if getattr(st, m)}
            zs = robust_z(values)
            med = _median(list(values.values())) if values else 0.0
            for cid, z in sorted(zs.items()):
                if abs(z) > self.z_threshold:
                    out.append(AuditFlag(cid, m, z, values[cid], med))
        return out

    def summary(self) -> Dict:
        return {"clients": {cid: st.summary()
                            for cid, st in sorted(self.clients.items())},
                "recorded": self.recorded,
                "flags": [f.to_dict() for f in self.flags()]}
