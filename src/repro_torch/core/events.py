"""Priority-queue virtual clock for the event-driven engine core.

Everything that happens in a simulated federation is an :class:`Event` on
one :class:`VirtualClock` (FLGo's ``ElemClock`` is the shape we follow):
client round completions, dropout/outage stalls, sync-message arrivals at
the server, client-side sync triggers, and the synchronous baseline's
round barriers.  The clock is a heap ordered by the total key

    (t, kind, cid, seq)

which pins a *deterministic* pop order even when events tie on arrival
time: earlier virtual time first, then event kind (arrivals drain before
the barrier that closes over them), then client id (two sync messages
landing at the same instant merge in client order — exactly the legacy
engine's ``(arrival, cid)`` heap order), then push order as the final
tie-break.  Payloads never participate in comparisons, so they may be
arbitrary (and mutable) objects.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Any, List, Optional, Tuple

# Event kinds, in pop-priority order at equal virtual time.  ROUND/STALL
# are trace markers (they carry no server state change); TRIGGER marks a
# client-side buffer-full decision; ARRIVAL is a sync message reaching the
# server; BARRIER closes a synchronous baseline round — it must pop after
# every arrival it closes over, hence the largest kind.
ROUND = 0       # a client finished one local boosting round
STALL = 1       # a dropout/outage stall ended
TRIGGER = 2     # client-side sync trigger (buffer reached I_t)
ARRIVAL = 3     # sync message arrived at the server
BARRIER = 4     # synchronous round barrier closed

KIND_NAMES = {ROUND: "round", STALL: "stall", TRIGGER: "trigger",
              ARRIVAL: "arrival", BARRIER: "barrier"}


@dataclass(frozen=True)
class Event:
    """One scheduled occurrence on the virtual clock."""
    t: float
    kind: int
    cid: int          # owning client, or -1 for server/global events
    seq: int          # monotonically increasing push counter
    payload: Any = None

    @property
    def kind_name(self) -> str:
        return KIND_NAMES.get(self.kind, str(self.kind))


class VirtualClock:
    """Min-heap of events with a monotone ``now`` and pinned tie-breaks."""

    def __init__(self) -> None:
        self._heap: List[Tuple[float, int, int, int, Any]] = []
        self._seq = 0
        self.now = 0.0
        self.n_pushed = 0
        self.n_popped = 0

    def push(self, t: float, kind: int, cid: int = -1,
             payload: Any = None) -> Event:
        """Schedule an event at virtual time ``t`` (>= now)."""
        seq = self._seq
        self._seq += 1
        heapq.heappush(self._heap, (float(t), kind, cid, seq, payload))
        self.n_pushed += 1
        return Event(float(t), kind, cid, seq, payload)

    def pop(self) -> Event:
        """Remove and return the next event; advances ``now`` monotonically."""
        t, kind, cid, seq, payload = heapq.heappop(self._heap)
        self.n_popped += 1
        if t > self.now:
            self.now = t
        return Event(t, kind, cid, seq, payload)

    def peek(self) -> Optional[Event]:
        if not self._heap:
            return None
        t, kind, cid, seq, payload = self._heap[0]
        return Event(t, kind, cid, seq, payload)

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)
