"""Scenario registry: the five paper domains (and stress variants) bound to
a data partitioner, a client-behavior mix, and paper-band expectations.

This is the single source of truth for "what is the edge-vision domain":
the :class:`~repro_torch.configs.paper_fedboost.DomainConfig` environment,
the partitioner from :mod:`repro_torch.data.partition`, the paper's Table-1
relative improvement bands, and *named behavior traces* per domain
(``legacy`` plus at least two correlated/time-varying mixes).  The
registry holds the JAX package's scenarios, name for name and field for
field.

A *trace factory* maps ``(domain, seed) -> behavior_for`` where
``behavior_for(cid)`` builds one :class:`ClientBehavior` per client; the
``legacy`` trace returns ``None`` so the engine installs its bit-for-bit
:class:`LegacyBehavior` shim.  Factories are called freshly per engine run
— stateful behaviors (Gilbert chains, outage processes) must never be
shared between a baseline and an enhanced run.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.configs.paper_fedboost import (
    CompensationConfig, DomainConfig, FedBoostConfig, SchedulerConfig)
from repro_torch.sim.behavior import (
    BlockchainLedger, BlockDelayBehavior, ClientBehavior, DiurnalBehavior,
    GilbertLinkBehavior, Link, SiteBehavior, SiteOutageProcess,
    TraceSchedule)

BehaviorFor = Callable[[int], ClientBehavior]
TraceFactory = Callable[[DomainConfig, int], Optional[BehaviorFor]]


# ------------------------------------------------------------- paper bands
@dataclass(frozen=True)
class PaperBand:
    """Table-1 relative-improvement bands (enhanced vs baseline), as
    (low, high) percent ranges; ``acc_delta_pp`` in percentage points.
    ``check`` asserts against the band floor minus a reproduction
    tolerance (small-seed, short-run reproductions sit inside the band on
    average but individual runs need slack)."""
    time_down: Tuple[float, float]
    comm_down: Tuple[float, float]
    conv_down: Tuple[float, float]
    acc_delta_pp: Tuple[float, float]
    tol_time: float = 12.0
    tol_comm: float = 8.0
    tol_acc: float = 2.0

    @property
    def midpoints(self) -> Tuple[float, float, float, float]:
        return tuple(0.5 * (lo + hi) for lo, hi in
                     (self.time_down, self.comm_down, self.conv_down,
                      self.acc_delta_pp))

    def check(self, row: Mapping[str, float]) -> List[str]:
        """Band-compliance failures for one {time_down, comm_down,
        acc_delta_pp} result row (empty = within band)."""
        fails = []
        floor = self.time_down[0] - self.tol_time
        if row["time_down"] < floor:
            fails.append(f"time_down {row['time_down']:.1f}% < {floor:.0f}%")
        floor = self.comm_down[0] - self.tol_comm
        if row["comm_down"] < floor:
            fails.append(f"comm_down {row['comm_down']:.1f}% < {floor:.0f}%")
        floor = self.acc_delta_pp[0] - self.tol_acc
        if row["acc_delta_pp"] < floor:
            fails.append(
                f"acc_delta {row['acc_delta_pp']:+.1f}pp < {floor:+.1f}pp")
        return fails


# --------------------------------------------------------------- scenarios
@dataclass(frozen=True)
class Scenario:
    """One registered deployment scenario: environment + partitioner +
    behavior traces + expectations."""
    name: str
    domain: DomainConfig
    band: PaperBand
    traces: Mapping[str, TraceFactory]
    partitioner: str = "dirichlet"          # iid | dirichlet | label_shard
    shards_per_client: int = 2              # label_shard knob
    n_rounds: int = 20                      # default boosting rounds
    serve_rate: float = 400.0               # replay nominal request rate
    time_warp: float = 20.0                 # behavior-seconds per serve-second
    variant_of: Optional[str] = None        # base scenario for variants
    notes: str = ""
    serve_replay: bool = True               # replay the serve phase at all?
    # engine profile: None auto-selects (FLEET_AUTO_CLIENTS); True forces
    # the vectorized fleet profile (repro_torch.core.fleet)
    fleet: Optional[bool] = None
    # extra make_domain_data kwargs (val_frac/test_frac/as_numpy — the
    # fleet scenarios shrink the held-out sets and skip jnp conversion)
    data_kwargs: Mapping = field(default_factory=dict)
    # FedBoostConfig field overrides applied after construction
    # (catch_up_cap, compensation, scheduler, ...)
    config_overrides: Mapping = field(default_factory=dict)
    # decentralized chain-of-record mode: the serving fleet is backed by a
    # chain of record instead of a sharded registry
    chain: bool = False

    def make_data(self, seed: int = 0) -> Dict:
        from repro_torch.data import make_domain_data
        return make_domain_data(self.domain, seed=seed,
                                partitioner=self.partitioner,
                                shards_per_client=self.shards_per_client,
                                **dict(self.data_kwargs))

    def fedboost_config(self, seed: int = 0,
                        n_rounds: Optional[int] = None) -> FedBoostConfig:
        dom = self.domain
        cfg = FedBoostConfig(
            n_clients=dom.n_clients,
            n_rounds=self.n_rounds if n_rounds is None else n_rounds,
            straggler_factor=dom.straggler_factor,
            dropout_prob=dom.dropout_prob, link_mbps=dom.link_mbps,
            seed=seed, balanced_init=dom.label_imbalance < 0.4)
        if self.config_overrides:
            cfg = replace(cfg, **dict(self.config_overrides))
        return cfg

    def behavior_for(self, trace: str, seed: int = 0
                     ) -> Optional[BehaviorFor]:
        """A fresh ``behavior_for`` hook for one engine run (or None for
        the legacy shim)."""
        if trace not in self.traces:
            raise KeyError(
                f"scenario {self.name!r} has no trace {trace!r}; "
                f"choose from {sorted(self.traces)}")
        return self.traces[trace](self.domain, seed)

    @property
    def nontrivial_traces(self) -> List[str]:
        return sorted(t for t in self.traces if t != "legacy")


SCENARIOS: Dict[str, Scenario] = {}


def register(sc: Scenario) -> Scenario:
    if sc.name in SCENARIOS:
        raise ValueError(f"scenario {sc.name!r} already registered")
    SCENARIOS[sc.name] = sc
    return sc


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r}; "
                       f"registered: {sorted(SCENARIOS)}") from None


def base_scenarios() -> List[str]:
    """The five paper domains, registry order."""
    return [n for n, s in SCENARIOS.items() if s.variant_of is None]


def variant_scenarios() -> List[str]:
    return [n for n, s in SCENARIOS.items() if s.variant_of is not None]


# ------------------------------------------------------- behavior factories
def _speeds(dom: DomainConfig, seed: int, tag: int) -> np.ndarray:
    """Per-client compute multipliers ~ LogUniform[1, straggler_factor],
    from a trace-local RNG (never the engine's — only the legacy shim may
    touch that stream)."""
    rng = np.random.RandomState(seed * 7919 + tag)
    return np.exp(rng.uniform(0.0, math.log(max(dom.straggler_factor, 1.0)),
                              size=dom.n_clients))


def _legacy(dom: DomainConfig, seed: int) -> None:
    return None             # engine installs the bit-for-bit scalar shim


def _diurnal(peak=0.95, trough=0.35, night_slowdown=1.5, period_s=24.0
             ) -> TraceFactory:
    """Phones on a day/night cycle, phases staggered across the fleet so
    availability is correlated-but-not-identical (time zones, habits)."""
    def make(dom: DomainConfig, seed: int) -> BehaviorFor:
        speeds = _speeds(dom, seed, 11)
        rng = np.random.RandomState(seed * 7919 + 12)
        phases = rng.uniform(0.0, period_s / 4.0, size=dom.n_clients)
        behaviors = [DiurnalBehavior(
            float(speeds[c]), period_s, float(phases[c]),
            np.random.RandomState(seed * 7919 + 100 + c),
            peak=peak, trough=trough, night_slowdown=night_slowdown,
            link_mbps=dom.link_mbps) for c in range(dom.n_clients)]
        return lambda cid: behaviors[cid]
    return make


def _gilbert(mean_good_s=8.0, mean_bad_s=2.0, drop_in_bad=0.6,
             bad_bw_frac=0.05, bad_latency_s=0.5) -> TraceFactory:
    """Bursty on/off radio links (Gilbert-Elliott): deep fades arrive in
    runs, not i.i.d. coin flips."""
    def make(dom: DomainConfig, seed: int) -> BehaviorFor:
        speeds = _speeds(dom, seed, 21)
        behaviors = [GilbertLinkBehavior(
            float(speeds[c]), np.random.RandomState(seed * 7919 + 200 + c),
            mean_good_s=mean_good_s, mean_bad_s=mean_bad_s,
            good=Link(0.05, dom.link_mbps),
            bad=Link(bad_latency_s, dom.link_mbps * bad_bw_frac),
            drop_in_bad=drop_in_bad) for c in range(dom.n_clients)]
        return lambda cid: behaviors[cid]
    return make


def _site_outage(clients_per_site=4, mean_up_s=20.0, mean_down_s=4.0
                 ) -> TraceFactory:
    """Correlated multi-client outages: clients grouped into sites (edge
    racks, hospital wings) that fail *together* — Poisson outage arrivals,
    exponential repair times, shared by every client on the site."""
    def make(dom: DomainConfig, seed: int) -> BehaviorFor:
        speeds = _speeds(dom, seed, 31)
        n_sites = max(1, dom.n_clients // clients_per_site)
        sites = [SiteOutageProcess(
            np.random.RandomState(seed * 7919 + 300 + s),
            mean_up_s=mean_up_s, mean_down_s=mean_down_s)
            for s in range(n_sites)]
        behaviors = [SiteBehavior(sites[c % n_sites], float(speeds[c]),
                                  link_mbps=dom.link_mbps)
                     for c in range(dom.n_clients)]
        return lambda cid: behaviors[cid]
    return make


def _block_delay(block_interval_s=0.4, confirmations=2, congestion_prob=0.1,
                 congestion_blocks=3,
                 commits_per_block=1) -> TraceFactory:
    """Blockchain peers: every uplink waits for inclusion on a *shared*
    ledger (commits serialize on block capacity — a synchronous round's
    burst of K commits queues ~K blocks deep) + confirmations, with
    occasional fee-market congestion spikes."""
    def make(dom: DomainConfig, seed: int) -> BehaviorFor:
        speeds = _speeds(dom, seed, 41)
        ledger = BlockchainLedger(np.random.RandomState(seed * 7919 + 499),
                                  block_interval_s=block_interval_s,
                                  commits_per_block=commits_per_block)
        behaviors = [BlockDelayBehavior(
            float(speeds[c]), np.random.RandomState(seed * 7919 + 400 + c),
            block_interval_s=block_interval_s, confirmations=confirmations,
            congestion_prob=congestion_prob,
            congestion_blocks=congestion_blocks,
            link_mbps=dom.link_mbps, fork_drop=dom.dropout_prob,
            ledger=ledger)
            for c in range(dom.n_clients)]
        return lambda cid: behaviors[cid]
    return make


# A recorded-trace example: a 12-simulated-second battery/duty cycle as it
# would come back from a fleet-telemetry dump.  Replayed (looped) through
# TraceSchedule over the per-client compute multiplier — this is the JSON
# shape ``TraceSchedule.from_json`` accepts from a file too.
BATTERY_TRACE_JSON: Dict = {
    "loop_s": 12.0,
    "segments": [
        {"t": 0.0, "available": True, "speed": 1.0},
        {"t": 5.0, "available": True, "speed": 2.5,          # battery saver
         "bandwidth_mbps": 1.0},
        {"t": 8.0, "available": False},                      # deep sleep
        {"t": 10.0, "available": True, "speed": 1.2},
    ],
}

DUTY_CYCLE_TRACE_JSON: Dict = {
    "loop_s": 8.0,
    "segments": [
        {"t": 0.0, "available": True},
        {"t": 5.5, "available": False},   # sensor sleeps 30% of each cycle
    ],
}


def _recorded_trace(name: str, stagger_s: float = 0.0,
                    base: Optional[TraceFactory] = None) -> TraceFactory:
    """Replay a checked-in ``artifacts/traces/<name>.json`` recording per
    client (loaded lazily, so registering the scenario never requires the
    artifacts directory to exist)."""
    def make(dom: DomainConfig, seed: int) -> BehaviorFor:
        from repro_torch.sim.traces import load_trace
        return _trace_replay(load_trace(name), stagger_s=stagger_s,
                             base=base)(dom, seed)
    return make


def _trace_replay(trace_json: Dict, stagger_s: float = 0.0,
                  base: Optional[TraceFactory] = None) -> TraceFactory:
    """Replay a recorded JSON trace per client (optionally staggering each
    client's phase within the loop, and optionally layered over another
    factory's behaviors)."""
    def make(dom: DomainConfig, seed: int) -> BehaviorFor:
        base_for = base(dom, seed) if base is not None else None
        speeds = _speeds(dom, seed, 51)

        def build(cid: int) -> ClientBehavior:
            inner = (base_for(cid) if base_for is not None else
                     _ConstantBehavior(float(speeds[cid]), dom.link_mbps))
            return TraceSchedule.from_json(trace_json, base=inner,
                                           phase_s=cid * stagger_s)
        behaviors = [build(c) for c in range(dom.n_clients)]
        return lambda cid: behaviors[cid]
    return make


class _ConstantBehavior(ClientBehavior):
    """Deterministic straggler: fixed speed + link, always available."""

    def __init__(self, speed: float, link_mbps: float,
                 latency_s: float = 0.05):
        self.speed = float(speed)
        self._link = Link(latency_s, link_mbps)

    def compute_time(self, work: float, t: float = 0.0) -> float:
        return work * self.speed

    def link(self, t: float) -> Link:
        return self._link


def _staggered_join(join_gap_s: float = 4.0) -> TraceFactory:
    """Cold start: client ``cid`` only comes online at ``cid * join_gap_s``
    (fleet rollout / enrollment ramp)."""
    def make(dom: DomainConfig, seed: int) -> BehaviorFor:
        speeds = _speeds(dom, seed, 61)

        def build(cid: int) -> ClientBehavior:
            inner = _ConstantBehavior(float(speeds[cid]), dom.link_mbps)
            return TraceSchedule(
                [{"t": 0.0, "available": False},
                 {"t": cid * join_gap_s, "available": True}], base=inner)
        behaviors = [build(c) for c in range(dom.n_clients)]
        return lambda cid: behaviors[cid]
    return make


# ------------------------------------------------------------ the registry
# Environment tables: the five paper domains' published sizes and
# heterogeneity knobs.
register(Scenario(
    name="edge_vision",
    domain=DomainConfig(
        name="edge_vision", n_samples=4000, n_features=64, n_clients=12,
        noniid_alpha=0.5, label_imbalance=0.5, noise=0.15,
        straggler_factor=5.0, dropout_prob=0.10, link_mbps=8.0),
    band=PaperBand((15, 35), (20, 40), (15, 25), (0.0, 2.0)),
    traces={
        "legacy": _legacy,
        # cameras racked 4-per-switch: whole racks drop together
        "rack_outage": _site_outage(clients_per_site=4,
                                    mean_up_s=18.0, mean_down_s=5.0),
        # shared backhaul congests on a rush-hour cycle
        "rush_hour": _diurnal(peak=0.98, trough=0.6, night_slowdown=1.0,
                              period_s=16.0),
    },
    serve_rate=500.0,
    notes="smart-city cameras, rack-correlated failures"))

register(Scenario(
    name="blockchain",
    domain=DomainConfig(
        name="blockchain", n_samples=5000, n_features=32, n_clients=8,
        noniid_alpha=1.0, label_imbalance=0.45, noise=0.20,
        straggler_factor=2.0, dropout_prob=0.02, link_mbps=2.0),
    band=PaperBand((24, 40), (30, 50), (15, 25), (-0.2, 2.0)),
    traces={
        "legacy": _legacy,
        # every sync waits for block inclusion + 2 confirmations
        "block_delay": _block_delay(block_interval_s=0.4, confirmations=2),
        # fee-market spikes: frequent multi-block congestion delays
        "congestion": _block_delay(block_interval_s=0.4, confirmations=3,
                                   congestion_prob=0.35,
                                   congestion_blocks=5),
    },
    serve_rate=300.0,
    notes="on-chain federated marketplace, confirmation-delayed links"))

register(Scenario(
    name="mobile",
    domain=DomainConfig(
        name="mobile", n_samples=6000, n_features=48, n_clients=32,
        noniid_alpha=0.2, label_imbalance=0.5, noise=0.18,
        straggler_factor=6.0, dropout_prob=0.15, link_mbps=5.0),
    band=PaperBand((14, 30), (17, 37), (10, 20), (-1.0, 2.0)),
    traces={
        "legacy": _legacy,
        # phones on staggered day/night cycles, slower + flakier at night
        "diurnal": _diurnal(peak=0.95, trough=0.3, night_slowdown=1.8,
                            period_s=24.0),
        # recorded battery/duty-cycle telemetry replayed per client
        "battery_trace": _trace_replay(BATTERY_TRACE_JSON, stagger_s=1.7),
        # checked-in diurnal recording (artifacts/traces/mobile_diurnal
        # .json): one reference handset's observed day, staggered per
        # client like a fleet across time zones
        "diurnal_trace": _recorded_trace("mobile_diurnal", stagger_s=1.3),
    },
    serve_rate=800.0,
    notes="keyboard personalization fleet, diurnal availability"))

register(Scenario(
    name="iot",
    domain=DomainConfig(
        name="iot", n_samples=4000, n_features=24, n_clients=24,
        noniid_alpha=0.3, label_imbalance=0.15, noise=0.10,
        straggler_factor=3.0, dropout_prob=0.12, link_mbps=1.0),
    band=PaperBand((12, 28), (15, 35), (10, 20), (-2.0, 2.0)),
    traces={
        "legacy": _legacy,
        # Gilbert-Elliott radio: deep fades arrive in bursts
        "gilbert": _gilbert(mean_good_s=8.0, mean_bad_s=2.0,
                            drop_in_bad=0.6),
        # recorded sensor duty cycle (sleeps 30% of every 8 s) over a
        # milder fading link
        "duty_cycle": _trace_replay(
            DUTY_CYCLE_TRACE_JSON, stagger_s=0.9,
            base=_gilbert(mean_good_s=12.0, mean_bad_s=1.0,
                          drop_in_bad=0.3)),
    },
    serve_rate=600.0,
    notes="anomaly detection on battery sensors, bursty LPWAN links"))

register(Scenario(
    name="healthcare",
    domain=DomainConfig(
        name="healthcare", n_samples=3000, n_features=40, n_clients=6,
        noniid_alpha=0.8, label_imbalance=0.20, noise=0.12,
        straggler_factor=2.5, dropout_prob=0.03, link_mbps=20.0),
    band=PaperBand((9, 25), (15, 35), (15, 25), (0.0, 3.0)),
    traces={
        "legacy": _legacy,
        # hospital wings (2 clients each) share maintenance windows that
        # are waited out, not retried
        "maintenance": _site_outage(clients_per_site=2,
                                    mean_up_s=25.0, mean_down_s=6.0),
        # compute contends with clinical load on a day cycle; the site
        # itself stays up (hospitals run 24/7)
        "night_shift": _diurnal(peak=1.0, trough=0.85, night_slowdown=2.5,
                                period_s=20.0),
    },
    serve_rate=200.0,
    notes="six hospitals, imbalanced diagnoses, maintenance windows"))


# ------------------------------------------------------------ stress variants
_mobile = get_scenario("mobile")
register(replace(
    _mobile, name="mobile_x4", variant_of="mobile",
    domain=replace(_mobile.domain, name="mobile_x4",
                   n_samples=24000, n_clients=128),
    traces={"legacy": _legacy,
            "diurnal": _mobile.traces["diurnal"]},
    serve_rate=1600.0,
    notes="scale-up: 4x the clients and samples of the mobile domain"))

_edge = get_scenario("edge_vision")
register(replace(
    _edge, name="edge_vision_churn", variant_of="edge_vision",
    traces={"legacy": _legacy,
            # adversarial churn: long correlated deep fades with near-total
            # loss — the regime where a sync barrier starves
            "churn": _gilbert(mean_good_s=4.0, mean_bad_s=3.0,
                              drop_in_bad=0.95, bad_bw_frac=0.02,
                              bad_latency_s=1.0)},
    notes="adversarial churn variant of edge_vision"))

# decentralized chain-of-record variant: same environment and paper band
# as the blockchain domain, with serving backed by a hash-linked chain of
# client commits instead of a central registry.
_blockchain = get_scenario("blockchain")
register(replace(
    _blockchain, name="blockchain_flchain", variant_of="blockchain",
    chain=True,
    traces={"legacy": _legacy,
            "block_delay": _blockchain.traces["block_delay"]},
    notes="server-less FLchain mode: chain-of-record replaces the "
          "central registry (arXiv:2112.07938)"))

_iot = get_scenario("iot")
register(replace(
    _iot, name="iot_coldstart", variant_of="iot",
    traces={"legacy": _legacy,
            # enrollment ramp: client k joins at t = 2.5k seconds
            "staggered_join": _staggered_join(join_gap_s=2.5)},
    notes="cold-start variant: clients enroll on a ramp"))

# fleet-scale smoke: 100k phones on tiny shards, driven by the vectorized
# fleet profile (repro_torch.core.fleet).  The band is deliberately loose —
# the scenario exists to exercise event-core + batched-kernel scale, not to
# reproduce Table 1, which small shards and capped catch-up cannot.
register(replace(
    _mobile, name="mobile_100k", variant_of="mobile",
    domain=replace(_mobile.domain, name="mobile_100k",
                   n_samples=400_000, n_clients=100_000),
    band=PaperBand((0, 60), (0, 60), (0, 60), (-5.0, 5.0),
                   tol_time=60.0, tol_comm=60.0, tol_acc=10.0),
    traces={"legacy": _legacy,
            "diurnal": _mobile.traces["diurnal"]},
    partitioner="iid",
    n_rounds=4,
    serve_rate=1600.0,
    serve_replay=False, fleet=True,
    data_kwargs={"val_frac": 0.004, "test_frac": 0.004, "as_numpy": True},
    config_overrides={
        "catch_up_cap": 16,                       # O(cap) catch-up per sync
        "compensation": CompensationConfig(decay="hinge"),
        "scheduler": SchedulerConfig(i_init=2),   # 2-round buffers
    },
    notes="fleet-scale smoke: 100k clients, vectorized fleet profile"))


# --------------------------------------------------- legacy-name exports
#: Canonical per-domain environment table: the five paper domains.
DOMAINS: Dict[str, DomainConfig] = {
    n: SCENARIOS[n].domain for n in base_scenarios()}

#: Table-1 band midpoints keyed by domain.
PAPER_BANDS: Dict[str, Tuple[float, float, float, float]] = {
    n: SCENARIOS[n].band.midpoints for n in base_scenarios()}
