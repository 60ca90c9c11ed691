"""Client-behavior models: the device/link simulation layer under the
federated engines.

The engines used to model heterogeneity as two i.i.d. scalars
(``straggler_factor``, ``dropout_prob``).  Real deployments are nothing
like that: phone availability follows the day/night cycle, IoT radios
burst between good and terrible (Gilbert-Elliott), hospital sites go down
*together* for maintenance, and blockchain peers pay a block-confirmation
delay on every message.  ASO-Fed (arXiv:1911.02134) and the FLchain
analysis (arXiv:2112.07938) both show that it is exactly this *correlated,
time-varying* behavior that separates async from sync methods — so the
simulator has to produce it.

A :class:`ClientBehavior` answers three questions the engine asks on every
round of one client's life:

* ``availability(t)``   — can the client participate right now?
* ``compute_time(work, t)`` — seconds to do ``work`` nominal seconds of
  compute, starting at ``t``;
* ``link(t)``           — the uplink as a (latency, bandwidth) pair.

plus ``stall_time(work, t)`` — the wall-clock penalty of an unavailable
round (defaults to ``compute_time``, matching the legacy dropout stall).

Timestamps are the engine's simulated clock and must be non-decreasing per
behavior instance (each instance belongs to exactly one client); stateful
models (Gilbert chains, outage processes) advance lazily to ``t``.

:class:`LegacyBehavior` reproduces the scalar model **bit-for-bit**: it
draws from the same RNG stream in the same order and computes the same
float expressions, so an engine constructed without an explicit
``behavior_for`` is unchanged down to the last bit at equal seeds.
"""
from __future__ import annotations

import bisect
import json
import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class Link:
    """One uplink observation: fixed latency + available bandwidth."""
    latency_s: float
    bandwidth_mbps: float

    def tx_time(self, nbytes: int) -> float:
        """Seconds to push ``nbytes`` through this link (engine cost model)."""
        return nbytes / (self.bandwidth_mbps / 8.0 * 1e6) + self.latency_s


class ClientBehavior:
    """Per-client device/link model driving the engines' cost simulation."""

    def availability(self, t: float) -> bool:
        """Can the client train/sync at simulated time ``t``?  May consume
        randomness; the engine calls it exactly once per round."""
        return True

    def compute_time(self, work: float, t: float = 0.0) -> float:
        """Seconds to perform ``work`` nominal seconds of compute at ``t``."""
        return work

    def link(self, t: float) -> Link:
        """The client's uplink at ``t``."""
        return Link(0.05, 10.0)

    def stall_time(self, work: float, t: float = 0.0) -> float:
        """Wall-clock penalty of an unavailable round.  The legacy model
        charges one extra compute round; outage models wait the window out."""
        return self.compute_time(work, t)

    def query_delay(self, t: float) -> float:
        """Extra delay a serving *query* pays on this client's link at
        ``t`` — the link latency by default.  Models where training
        uplinks pay costs queries do not (a blockchain commit waits for
        inclusion; a read does not) override this."""
        return self.link(t).latency_s


# --------------------------------------------------------------- legacy shim
class LegacyBehavior(ClientBehavior):
    """The pre-simulator scalar model as a behavior.

    Bit-for-bit contract: ``availability`` consumes exactly one
    ``rng.rand()`` (the old per-round dropout draw), ``compute_time``
    computes ``work * speed`` (the old ``BASE_ROUND_S * c.speed``), and
    ``link`` is the constant (``LATENCY_S``, ``cfg.link_mbps``) pair —
    identical draws in identical order, identical float expressions.
    """

    def __init__(self, speed: float, dropout_prob: float, link_mbps: float,
                 latency_s: float, rng: np.random.RandomState):
        self.speed = float(speed)
        self.dropout_prob = float(dropout_prob)
        self._link = Link(float(latency_s), float(link_mbps))
        self.rng = rng

    def availability(self, t: float) -> bool:
        return not (self.rng.rand() < self.dropout_prob)

    def compute_time(self, work: float, t: float = 0.0) -> float:
        return work * self.speed

    def link(self, t: float) -> Link:
        return self._link


def legacy_behaviors(cfg, n: int, rng: np.random.RandomState,
                     latency_s: float = 0.05) -> List[LegacyBehavior]:
    """The engine's default: one :class:`LegacyBehavior` per client with
    speeds drawn log-uniform in ``[1, straggler_factor]`` — the exact
    vectorized draw (and therefore RNG stream position) the engine used
    before behaviors existed.  All clients share ``rng`` so the per-round
    availability draws interleave in the legacy order too."""
    speeds = np.exp(rng.uniform(0.0, math.log(cfg.straggler_factor), size=n))
    return [LegacyBehavior(float(speeds[i]), cfg.dropout_prob, cfg.link_mbps,
                           latency_s, rng) for i in range(n)]


# ------------------------------------------------------------ mobile diurnal
class DiurnalBehavior(ClientBehavior):
    """Phone-style day/night cycle: availability, compute speed, and link
    bandwidth all follow a sinusoidal daylight curve (plus a battery duty
    cycle — the device naps when "charging overnight" is over and the
    battery saver kicks in, modeled by the trough availability).

    ``daylight(t)`` in [0, 1]; availability is a Bernoulli draw with
    probability interpolated between ``trough`` and ``peak``; compute slows
    by up to ``night_slowdown`` at full night; bandwidth scales between 60%
    and 100% of nominal with daylight (congested evening cells).
    """

    def __init__(self, speed: float, period_s: float, phase_s: float,
                 rng: np.random.RandomState, *, peak: float = 0.95,
                 trough: float = 0.35, night_slowdown: float = 1.5,
                 link_mbps: float = 5.0, latency_s: float = 0.05):
        assert 0.0 <= trough <= peak <= 1.0
        self.speed = float(speed)
        self.period_s = float(period_s)
        self.phase_s = float(phase_s)
        self.peak, self.trough = float(peak), float(trough)
        self.night_slowdown = float(night_slowdown)
        self.link_mbps, self.latency_s = float(link_mbps), float(latency_s)
        self.rng = rng

    def daylight(self, t: float) -> float:
        return 0.5 * (1.0 + math.sin(
            2.0 * math.pi * (t + self.phase_s) / self.period_s))

    def availability(self, t: float) -> bool:
        p = self.trough + (self.peak - self.trough) * self.daylight(t)
        return self.rng.rand() < p

    def compute_time(self, work: float, t: float = 0.0) -> float:
        slow = 1.0 + self.night_slowdown * (1.0 - self.daylight(t))
        return work * self.speed * slow

    def link(self, t: float) -> Link:
        scale = 0.6 + 0.4 * self.daylight(t)
        return Link(self.latency_s, self.link_mbps * scale)


# ----------------------------------------------------------- IoT bursty link
class GilbertLinkBehavior(ClientBehavior):
    """Gilbert-Elliott two-state radio: the link alternates between a good
    and a bad state with exponential sojourn times.  In the bad state the
    bandwidth collapses, latency spikes, and rounds are lost with
    ``drop_in_bad`` probability (deep fade = the legacy dropout, but bursty
    and autocorrelated instead of i.i.d.)."""

    def __init__(self, speed: float, rng: np.random.RandomState, *,
                 mean_good_s: float = 8.0, mean_bad_s: float = 2.0,
                 good: Link = Link(0.05, 1.0), bad: Link = Link(0.5, 0.05),
                 drop_in_bad: float = 0.6, drop_in_good: float = 0.02):
        self.speed = float(speed)
        self.rng = rng
        self.mean_good_s, self.mean_bad_s = float(mean_good_s), float(mean_bad_s)
        self.good, self.bad = good, bad
        self.drop_in_bad = float(drop_in_bad)
        self.drop_in_good = float(drop_in_good)
        self._good_now = True
        self._until = float(rng.exponential(self.mean_good_s))

    def _advance(self, t: float) -> None:
        while t >= self._until:
            self._good_now = not self._good_now
            mean = self.mean_good_s if self._good_now else self.mean_bad_s
            self._until += float(self.rng.exponential(mean))

    def in_good_state(self, t: float) -> bool:
        self._advance(t)
        return self._good_now

    def availability(self, t: float) -> bool:
        drop = (self.drop_in_good if self.in_good_state(t)
                else self.drop_in_bad)
        return not (self.rng.rand() < drop)

    def compute_time(self, work: float, t: float = 0.0) -> float:
        return work * self.speed

    def link(self, t: float) -> Link:
        return self.good if self.in_good_state(t) else self.bad


# ------------------------------------------------- correlated site outages
class SiteOutageProcess:
    """A shared outage process for one *site* (an edge rack, a hospital
    wing): Poisson outage arrivals with exponential durations, sampled
    lazily.  Every client attached to the site observes the *same* windows
    — the correlated multi-client failure the i.i.d. scalar model cannot
    produce."""

    def __init__(self, rng: np.random.RandomState, *,
                 mean_up_s: float = 20.0, mean_down_s: float = 4.0):
        self.rng = rng
        self.mean_up_s, self.mean_down_s = float(mean_up_s), float(mean_down_s)
        self._windows: List[tuple] = []       # (start, end), ascending
        self._starts: List[float] = []        # parallel starts for bisect
        self._horizon = 0.0                   # sampled up to here

    def _extend(self, t: float) -> None:
        while self._horizon <= t:
            start = self._horizon + float(self.rng.exponential(self.mean_up_s))
            end = start + float(self.rng.exponential(self.mean_down_s))
            self._windows.append((start, end))
            self._starts.append(start)
            self._horizon = end

    def _window_at(self, t: float):
        self._extend(t)
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and self._windows[i][0] <= t < self._windows[i][1]:
            return self._windows[i]
        return None

    def down(self, t: float) -> bool:
        return self._window_at(t) is not None

    def remaining(self, t: float) -> float:
        """Seconds until the current outage (if any) ends."""
        w = self._window_at(t)
        return w[1] - t if w is not None else 0.0


class SiteBehavior(ClientBehavior):
    """A client pinned to a :class:`SiteOutageProcess`: unavailable exactly
    while its site is down, and an unavailable round stalls until the
    outage clears (maintenance windows are waited out, not retried)."""

    def __init__(self, site: SiteOutageProcess, speed: float, *,
                 link_mbps: float = 10.0, latency_s: float = 0.05):
        self.site = site
        self.speed = float(speed)
        self._link = Link(float(latency_s), float(link_mbps))

    def availability(self, t: float) -> bool:
        return not self.site.down(t)

    def compute_time(self, work: float, t: float = 0.0) -> float:
        return work * self.speed

    def link(self, t: float) -> Link:
        return self._link

    def stall_time(self, work: float, t: float = 0.0) -> float:
        return max(self.site.remaining(t), self.compute_time(work, t))


# ------------------------------------------------------- blockchain confirm
class BlockchainLedger:
    """The *shared* chain every peer commits through: one message per
    block slot.  This is what actually separates sync from async on a
    chain (the FLchain analysis, arXiv:2112.07938): a synchronous round
    dumps K commits at once and the K-th waits ~K block intervals for
    inclusion, while the async method's sparse syncs usually find the next
    block free.  ``commit(t)`` reserves the next free slot at or after
    ``t`` and returns the inclusion wait."""

    def __init__(self, rng: np.random.RandomState, *,
                 block_interval_s: float = 0.4,
                 commits_per_block: int = 1,
                 prune_every: int = 64):
        self.rng = rng
        self.block_interval_s = float(block_interval_s)
        self.gap = self.block_interval_s / max(1, int(commits_per_block))
        self._slots: List[float] = []    # reserved slot times, ascending
        # slot pruning: committers register a *cursor* and stamp every
        # commit with it.  Per-cursor times are non-decreasing (the
        # ClientBehavior timestamp contract), so min(cursors) is the
        # earliest time any future commit can carry — reserved slots
        # more than ``gap`` older can never collide again and are
        # dropped every ``prune_every`` commits.  Cursor-less commits
        # keep the conservative unbounded behavior (no cursor floor ->
        # no pruning), so mixed callers stay exact.
        self.prune_every = int(prune_every)
        self._cursors: List[float] = []
        self._untracked = False          # any commit ever made cursor-less
        self._since_prune = 0
        self.pruned_slots = 0

    def register(self) -> int:
        """Register one committer; returns the cursor to pass to
        :meth:`commit`.  Pruning only engages when *every* commit on this
        ledger is cursor-stamped."""
        self._cursors.append(float("-inf"))
        return len(self._cursors) - 1

    @property
    def live_slots(self) -> int:
        return len(self._slots)

    def commit(self, t: float, cursor: Optional[int] = None) -> float:
        """Seconds from ``t`` until this message's block is mined."""
        # residual wait to the next block (Poisson arrivals), then the
        # first slot >= ``gap`` away from every reserved one.  Slots are
        # kept sorted and searched by *simulated* time, so callers need
        # not commit in time order (the enhanced engine advances clients
        # one at a time — an early-clock commit issued late must not
        # queue behind later-clock slots it precedes on chain).
        if cursor is None:
            self._untracked = True
        else:
            self._cursors[cursor] = max(self._cursors[cursor], float(t))
        earliest = t + float(self.rng.exponential(self.block_interval_s))
        slot = earliest
        i = bisect.bisect_left(self._slots, slot - self.gap)
        while i < len(self._slots) and self._slots[i] < slot + self.gap:
            slot = max(slot, self._slots[i] + self.gap)
            i += 1
        bisect.insort(self._slots, slot)
        self._since_prune += 1
        if self._since_prune >= self.prune_every:
            self._since_prune = 0
            self._prune()
        return slot - t

    def _prune(self) -> None:
        if self._untracked or not self._cursors:
            return
        floor = min(self._cursors)
        if floor == float("-inf"):
            return
        # a future commit at t >= floor only scans slots >= t - gap; any
        # slot strictly below floor - gap is unreachable forever
        cut = bisect.bisect_left(self._slots, floor - self.gap)
        if cut:
            self.pruned_slots += cut
            del self._slots[:cut]


class BlockDelayBehavior(ClientBehavior):
    """Blockchain peer: every message waits for block inclusion plus
    ``confirmations - 1`` further blocks.  With a shared
    :class:`BlockchainLedger` the inclusion wait queues on chain capacity
    (commits serialize — the correlated cost the i.i.d. model misses);
    without one, the residual wait is i.i.d. exponential.  Congestion
    occasionally bumps a message by a few extra blocks (fee-market
    spikes)."""

    def __init__(self, speed: float, rng: np.random.RandomState, *,
                 block_interval_s: float = 0.6, confirmations: int = 2,
                 congestion_prob: float = 0.1, congestion_blocks: int = 3,
                 link_mbps: float = 2.0, latency_s: float = 0.05,
                 fork_drop: float = 0.02,
                 ledger: Optional[BlockchainLedger] = None):
        self.speed = float(speed)
        self.rng = rng
        self.block_interval_s = float(block_interval_s)
        self.confirmations = int(confirmations)
        self.congestion_prob = float(congestion_prob)
        self.congestion_blocks = int(congestion_blocks)
        self.link_mbps, self.latency_s = float(link_mbps), float(latency_s)
        self.fork_drop = float(fork_drop)
        self.ledger = ledger
        # per-behavior timestamps are non-decreasing, so each client
        # registers a ledger cursor — the shared ledger prunes slots no
        # live client can collide with (bounded memory at fleet scale)
        self._cursor = ledger.register() if ledger is not None else None

    def availability(self, t: float) -> bool:
        # a fork orphans the round's message: the legacy dropout analogue
        return not (self.rng.rand() < self.fork_drop)

    def compute_time(self, work: float, t: float = 0.0) -> float:
        return work * self.speed

    def link(self, t: float) -> Link:
        if self.ledger is not None:
            wait = self.ledger.commit(t, cursor=self._cursor)
        else:
            wait = float(self.rng.exponential(self.block_interval_s))
        wait += (self.confirmations - 1) * self.block_interval_s
        if self.rng.rand() < self.congestion_prob:
            wait += self.congestion_blocks * self.block_interval_s
        return Link(self.latency_s + wait, self.link_mbps)

    def query_delay(self, t: float) -> float:
        # serving reads see the latest *confirmed* state — they neither
        # reserve a ledger slot nor wait for inclusion
        return self.latency_s


# ------------------------------------------------------------ trace replay
_TRACE_FIELDS = ("available", "speed", "latency_s", "bandwidth_mbps")


class TraceSchedule(ClientBehavior):
    """Piecewise-constant behavior from a recorded trace, optionally
    layered over a ``base`` behavior.

    A trace is a list of segments ``{"t": start, ...fields}``, sorted by
    ``t``; each segment holds any subset of ``available`` (bool, ANDed with
    the base), ``speed`` (multiplier on the base compute time), and
    ``latency_s``/``bandwidth_mbps`` (overriding the base link).  With
    ``loop_s`` set the trace repeats with that period — a recorded day
    replays forever — and ``phase_s`` rotates the cycle (stagger one
    recorded trace across a fleet without rewriting its segments); before
    the first segment a looped trace continues its last segment (cyclic),
    a one-shot trace clamps to its first.  ``from_json``/``to_json``
    round-trip the schedule, so measured deployments drop straight into
    the scenario registry."""

    def __init__(self, segments: Sequence[Dict], *,
                 base: Optional[ClientBehavior] = None,
                 loop_s: Optional[float] = None, phase_s: float = 0.0):
        segs = sorted((dict(s) for s in segments), key=lambda s: s["t"])
        if not segs:
            raise ValueError("TraceSchedule needs at least one segment")
        for s in segs:
            unknown = set(s) - {"t"} - set(_TRACE_FIELDS)
            if unknown:
                raise ValueError(f"unknown trace fields {sorted(unknown)}")
        self.segments = segs
        self._starts = [s["t"] for s in segs]
        self.base = base or ClientBehavior()
        self.loop_s = None if loop_s is None else float(loop_s)
        self.phase_s = float(phase_s)

    def _segment(self, t: float) -> Dict:
        t += self.phase_s
        if self.loop_s is not None:
            t = t % self.loop_s
        i = bisect.bisect_right(self._starts, t) - 1
        if i < 0:
            # before the first start: a cycle is mid-way through its last
            # segment; a one-shot trace hasn't begun — clamp to the first
            return self.segments[-1 if self.loop_s is not None else 0]
        return self.segments[i]

    def availability(self, t: float) -> bool:
        ok = self._segment(t).get("available", True)
        # base consulted second: its RNG draw only happens while the trace
        # says the device is on at all (an off phone draws nothing)
        return bool(ok) and self.base.availability(t)

    def compute_time(self, work: float, t: float = 0.0) -> float:
        return self.base.compute_time(work, t) * float(
            self._segment(t).get("speed", 1.0))

    def link(self, t: float) -> Link:
        seg, base = self._segment(t), self.base.link(t)
        return Link(float(seg.get("latency_s", base.latency_s)),
                    float(seg.get("bandwidth_mbps", base.bandwidth_mbps)))

    # --------------------------------------------------------------- JSON
    def to_json(self) -> Dict:
        out: Dict = {"segments": [dict(s) for s in self.segments]}
        if self.loop_s is not None:
            out["loop_s"] = self.loop_s
        if self.phase_s:
            out["phase_s"] = self.phase_s
        return out

    @classmethod
    def from_json(cls, obj, *, base: Optional[ClientBehavior] = None,
                  phase_s: float = 0.0) -> "TraceSchedule":
        """Build from a dict (``{"segments": [...], "loop_s": ...}``), a
        bare segment list, or a JSON string of either."""
        if isinstance(obj, str):
            obj = json.loads(obj)
        if isinstance(obj, list):
            obj = {"segments": obj}
        return cls(obj["segments"], base=base, loop_s=obj.get("loop_s"),
                   phase_s=obj.get("phase_s", phase_s))

    @classmethod
    def from_file(cls, path, *, base: Optional[ClientBehavior] = None
                  ) -> "TraceSchedule":
        with open(path) as f:
            return cls.from_json(json.load(f), base=base)
