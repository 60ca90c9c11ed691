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

This package carries the base class and the legacy model, which is what
the engine installs by default; the correlated and trace-driven models
come with the scenario harness.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

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
