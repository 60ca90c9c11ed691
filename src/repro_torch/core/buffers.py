"""Buffer-based synchronization (paper §Methodology).

Each client accumulates ``(weak-learner params, local error eps, vote weight
alpha, local round stamp)`` between synchronization events; at sync the
whole buffer crosses the network once and the server applies delayed weight
compensation to each entry based on its staleness.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List

# Per-entry wire overhead beyond the learner params themselves:
# eps (f32) + alpha (f32) + round stamp (i32).  This is THE single source
# for the constant — the engine's accounting and ClientBuffer.nbytes both
# route through entry_wire_bytes so they cannot drift apart.
ENTRY_OVERHEAD_BYTES = 12


@dataclass
class BufferEntry:
    params: Dict
    eps: float
    alpha: float
    round_stamp: int          # client-local boosting round when trained


def entry_wire_bytes(entry: "BufferEntry", param_bytes: Callable) -> int:
    """Bytes one buffered entry occupies on the wire."""
    return int(param_bytes(entry.params)) + ENTRY_OVERHEAD_BYTES


def payload_wire_bytes(entries: Iterable["BufferEntry"],
                       param_bytes: Callable) -> int:
    """Wire size of a sync payload (sans message header)."""
    return sum(entry_wire_bytes(e, param_bytes) for e in entries)


@dataclass
class ClientBuffer:
    client_id: int
    entries: List[BufferEntry] = field(default_factory=list)

    def add(self, params: Dict, eps: float, alpha: float, stamp: int) -> None:
        self.entries.append(BufferEntry(params, eps, alpha, stamp))

    def flush(self) -> List[BufferEntry]:
        out, self.entries = self.entries, []
        return out

    def __len__(self) -> int:
        return len(self.entries)

    def nbytes(self, param_bytes: Callable) -> int:
        """Wire size of the buffered payload (params + eps/alpha/stamp)."""
        return payload_wire_bytes(self.entries, param_bytes)
