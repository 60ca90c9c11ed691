"""Process-wide event/trace layer: nested spans on two clocks.

Every span records a *wall-clock* interval (``time.perf_counter``) and,
optionally, a *simulated-clock* interval (``sim_t0``/``sim_t1``) — the
engines stamp spans with the event-queue virtual time, the serving stack
with the caller-supplied serving clock, so one exported timeline merges
"what the hardware did" with "when the simulation said it happened".

Tracing is **off by default** and the disabled path is a true no-op: the
module-level :func:`span` helper returns the shared :data:`NULL_SPAN`
singleton without allocating anything, so instrumentation costs one global
load and one ``is None`` test on the serving hot path (pinned by
``tests/test_obs.py::test_disabled_span_is_shared_noop``).

Beyond the implicit nesting stack, spans carry a **distributed trace
identity**: every root span allocates a fresh ``trace_id``, children
inherit it, and a :class:`TraceContext` captured from one span can be
handed across hosts/nodes (a queued serving request, an on-chain commit)
to continue the same trace elsewhere.  Because the *stack* parent of a
deferred continuation is whatever span happens to be open at replay time
(a ``serve.batch`` wall-contains requests from many traces), causality
across traces is carried by explicit ``links`` — ``(trace_id, span_id)``
pairs back to the context that was propagated — and ``obs_report --check``
validates that any span whose trace differs from its stack parent's
carries such a link.

Finished spans land in a bounded in-memory ring (oldest dropped first) and
export as JSON Lines — a ``meta`` header line, then one object per span::

    {"meta": {"schema": 2, "dropped": 0, "started": 41, "exported": 41}}
    {"name": "serve.batch",          # dotted namespace (train./serve./...)
     "span": 7, "parent": 3,         # ids; parent null for roots
     "trace": "t000004",             # distributed trace identity
     "host": "host-1",               # emitting host/node ("" when unbound)
     "links": [["t000002", 5]],      # causal edges into other traces
     "t0": 0.0123, "t1": 0.0456,     # wall clock, perf_counter seconds
     "sim_t0": 1.5, "sim_t1": 1.52,  # simulated clock (null when unstamped)
     "attrs": {"tenant": "mobile", "queue_s": 0.004, ...}}

Nesting is by ``parent`` ids: a span opened while another is open becomes
its child (one implicit stack per tracer).  The tracer is deliberately
single-threaded — everything in this repo advances a simulated clock from
one thread; a threaded ingress would hold one tracer per worker.

Two more clocks join in where the program runs on a card:

* while a torch profiler runs, every span also opens a profiler range of
  its own name, so the span stands on the profiler's timeline, on the
  device trace's clock (the export and a chrome trace of the run join on
  the name and the order of start).  The range is torch's C++ fast path
  (``_RecordFunctionFast``: a CPU event of the span's name, 1.2 µs under
  the profiler on an H100's host against 11.3 µs for
  ``torch.profiler.record_function``, which is the fallback where a torch
  lacks it);
* a span opened with ``device=True`` records a CUDA event at its start
  and at its end, on the stream current at its start.  Nothing waits for
  them there: :meth:`Tracer.resolve` (called by the export) turns every
  finished pair into a ``device_ms`` attribute, observes it into the
  span's ``device_sink`` histogram where one is set, and keeps the two
  events for later spans.

A span's ``t0`` and ``t1`` leave out its own recording (the range and the
events), and ``rec_s`` (exported where it is not 0) is what its
descendants' recording took inside them: ``t1 - t0 - rec_s`` is the host's
own work.
"""
from __future__ import annotations

import itertools
import json
import time
from collections import deque
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import torch

_AUTOGRAD_PROFILER = torch.autograd.profiler
if hasattr(_AUTOGRAD_PROFILER, "_is_profiler_enabled"):
    def profiler_running() -> bool:
        """Whether a torch profiler is recording in this process."""
        return _AUTOGRAD_PROFILER._is_profiler_enabled
else:
    profiler_running = torch._C._autograd._profiler_enabled
_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.profiler.record_function)
_STREAMS: Dict[Tuple[int, int, int], "torch.cuda.Stream"] = {}


def _current_stream() -> "torch.cuda.Stream":
    """The current CUDA stream, one object kept for each: the lookup is
    a C call, where ``torch.cuda.current_stream()`` builds a new
    ``Stream`` under a device guard each time."""
    key = torch._C._cuda_getCurrentStream(torch._C._cuda_getDevice())
    stream = _STREAMS.get(key)
    if stream is None:
        stream = _STREAMS[key] = torch.cuda.Stream(
            stream_id=key[0], device_index=key[1], device_type=key[2])
    return stream


@dataclass(frozen=True)
class TraceContext:
    """The propagable identity of one span: enough to continue its trace
    on another host (set the continuation's ``trace_id``) and to record
    the causal edge back (a ``(trace_id, span_id)`` link)."""
    trace_id: str
    span_id: int
    host: str = ""


def _norm_links(ctx, link) -> List[Tuple[str, int]]:
    """Normalize the ``ctx``/``link`` kwargs into ``(trace_id, span_id)``
    pairs.  ``link`` accepts a single :class:`TraceContext` or an iterable
    of them; ``ctx`` always contributes its own edge."""
    out: List[Tuple[str, int]] = []
    if ctx is not None:
        out.append((ctx.trace_id, ctx.span_id))
    if link is not None:
        if isinstance(link, TraceContext):
            link = (link,)
        out.extend((lc.trace_id, lc.span_id) for lc in link if lc is not None)
    return out


class Span:
    """One traced interval.  Use as a context manager (``with tracer.span
    (...)``) or end explicitly via :meth:`end`."""

    __slots__ = ("name", "span_id", "parent_id", "trace_id", "host",
                 "links", "t0", "t1", "sim_t0", "sim_t1", "attrs",
                 "device_sink", "rec_s", "_tracer", "_range", "_events",
                 "_rec0")

    def __init__(self, tracer: "Tracer", name: str, span_id: int,
                 parent_id: Optional[int], sim_t: Optional[float],
                 attrs: Dict, trace_id: str = "", host: str = "",
                 links: Optional[List[Tuple[str, int]]] = None):
        self._tracer = tracer
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.trace_id = trace_id
        self.host = host
        self.links = links or []
        self.t0 = time.perf_counter()
        self.t1: Optional[float] = None
        self.sim_t0 = None if sim_t is None else float(sim_t)
        self.sim_t1: Optional[float] = None
        self.attrs = attrs
        self.device_sink = None    # a histogram given the device seconds
        self.rec_s = 0.0           # descendants' recording inside t0..t1
        self._range = None         # the profiler's range
        self._events = None        # (stream, start), then (start, stop)
        self._rec0 = tracer.rec_s

    # ------------------------------------------------------------- surface
    @property
    def ctx(self) -> TraceContext:
        """The propagable context of this span — hand it to whatever will
        continue this trace on another host/node."""
        return TraceContext(self.trace_id, self.span_id, self.host)

    def set(self, **attrs) -> "Span":
        """Attach/overwrite attributes; returns self for chaining.  Valid
        after :meth:`end` too (the ring holds the span object, so late
        annotations — e.g. the rid assigned after admission — still
        export)."""
        self.attrs.update(attrs)
        return self

    def end_sim(self, sim_t: float) -> "Span":
        """Stamp the simulated end time (wall end still set by end())."""
        self.sim_t1 = float(sim_t)
        return self

    def end(self, sim_t: Optional[float] = None) -> None:
        if self.t1 is not None:       # idempotent: with-block + manual end
            return
        t1 = time.perf_counter()
        tracer = self._tracer
        self.rec_s = tracer.rec_s - self._rec0
        if sim_t is not None:
            self.sim_t1 = float(sim_t)
        if self._events is not None:
            stream, start = self._events
            stop = tracer._event()
            stop.record(stream)
            self._events = (start, stop)
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
        self.t1 = t1
        tracer._finish(self)
        tracer.rec_s += time.perf_counter() - t1

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self.end()

    # --------------------------------------------------------------- export
    def to_dict(self) -> Dict:
        d = {"name": self.name, "span": self.span_id,
             "parent": self.parent_id, "trace": self.trace_id,
             "host": self.host, "t0": self.t0, "t1": self.t1,
             "sim_t0": self.sim_t0, "sim_t1": self.sim_t1,
             "attrs": self.attrs}
        if self.rec_s:
            d["rec_s"] = self.rec_s
        if self.links:
            d["links"] = [list(l) for l in self.links]
        return d


class _NullSpan:
    """The shared disabled-tracing span: every operation is a no-op.  A
    single module-level instance is returned for *every* span request while
    tracing is off, so the hot path never allocates."""

    __slots__ = ()

    ctx = None                 # no trace identity while tracing is off

    def set(self, **attrs) -> "_NullSpan":
        return self

    def end_sim(self, sim_t: float) -> "_NullSpan":
        return self

    def end(self, sim_t: Optional[float] = None) -> None:
        pass

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        pass


NULL_SPAN = _NullSpan()


class Tracer:
    """Span factory + bounded ring of finished spans.

    ``ring`` bounds memory: a long soak keeps the most recent spans and
    drops the oldest (dropped count in :attr:`dropped` — surfaced by the
    export meta line so a truncated ring is never read as complete).
    """

    def __init__(self, ring: int = 65536):
        self._ring: deque = deque(maxlen=int(ring))
        # finished device spans not yet resolved, a subset of the ring
        self._pending: deque = deque(maxlen=int(ring))
        self._free: List = []              # resolved events, for reuse
        self.rec_s = 0.0    # host seconds spent recording, outside spans
        self._stack: List[Span] = []       # open spans (nesting)
        self._ids = itertools.count(1)
        self._trace_ids = itertools.count(1)
        self.dropped = 0
        self.started = 0

    # ------------------------------------------------------------ creation
    def _identity(self, ctx: Optional[TraceContext], host: Optional[str]
                  ) -> Tuple[str, str]:
        """Resolve (trace_id, host) for a new span: an explicit ``ctx``
        continues its trace, otherwise the innermost open span's trace is
        inherited, otherwise a fresh trace starts."""
        parent = self._stack[-1] if self._stack else None
        if ctx is not None:
            tid = ctx.trace_id
        elif parent is not None:
            tid = parent.trace_id
        else:
            tid = f"t{next(self._trace_ids):06d}"
        if host is None:
            host = parent.host if parent is not None else ""
        return tid, host

    def span(self, name: str, sim_t: Optional[float] = None,
             ctx: Optional[TraceContext] = None,
             host: Optional[str] = None, link=None, device: bool = False,
             **attrs) -> Span:
        """Open a nested span; the parent is the innermost open span.
        ``ctx`` continues a propagated trace (and records the causal link
        back), ``host`` stamps the emitting host/node, ``link`` records
        extra cross-trace edges.  ``device=True`` times the span on the
        current CUDA stream as well (pass it only for work on a card)."""
        c0 = time.perf_counter()
        parent = self._stack[-1] if self._stack else None
        tid, hid = self._identity(ctx, host)
        sp = Span(self, name, next(self._ids),
                  parent.span_id if parent is not None else None,
                  sim_t, attrs, trace_id=tid, host=hid,
                  links=_norm_links(ctx, link))
        if profiler_running():
            sp._range = _RANGE(name)
            sp._range.__enter__()
        if device:
            stream = _current_stream()
            start = self._event()
            start.record(stream)
            sp._events = (stream, start)
        self._stack.append(sp)
        self.started += 1
        sp.t0 = time.perf_counter()
        self.rec_s += sp.t0 - c0
        sp._rec0 = self.rec_s
        return sp

    def _event(self) -> "torch.cuda.Event":
        """A timing CUDA event, one that a resolved span gave back where
        there is one."""
        return (self._free.pop() if self._free
                else torch.cuda.Event(enable_timing=True))

    def point(self, name: str, sim_t0: Optional[float] = None,
              sim_t1: Optional[float] = None,
              ctx: Optional[TraceContext] = None,
              host: Optional[str] = None, link=None, **attrs) -> Span:
        """Record an already-finished (instant) span — an event.  It is a
        child of the innermost open span but never enters the stack."""
        parent = self._stack[-1] if self._stack else None
        tid, hid = self._identity(ctx, host)
        sp = Span(self, name, next(self._ids),
                  parent.span_id if parent is not None else None,
                  sim_t0, attrs, trace_id=tid, host=hid,
                  links=_norm_links(ctx, link))
        sp.sim_t1 = None if sim_t1 is None else float(sim_t1)
        self.started += 1
        sp.end()
        return sp

    def _finish(self, sp: Span) -> None:
        # pop through the stack to this span: children left open by an
        # early exit are abandoned rather than corrupting later parents
        if self._stack and self._stack[-1] is sp:
            self._stack.pop()
        elif any(s is sp for s in self._stack):
            while self._stack and self._stack[-1] is not sp:
                self._stack.pop()
            if self._stack:
                self._stack.pop()
        if len(self._ring) == self._ring.maxlen:
            self.dropped += 1
        self._ring.append(sp)
        if sp._events is not None:
            self._pending.append(sp)

    def resolve(self) -> None:
        """Give every finished device span its ``device_ms`` (and its
        ``device_sink`` the seconds).  Waits once, for the last span's end
        event; an end event on another stream still running is waited
        for on its own."""
        if not self._pending:
            return
        self._pending[-1]._events[1].synchronize()
        while self._pending:
            sp = self._pending.popleft()
            start, stop = sp._events
            if not stop.query():
                stop.synchronize()
            ms = start.elapsed_time(stop)
            sp.attrs["device_ms"] = ms
            if sp.device_sink is not None:
                sp.device_sink.observe(ms * 1e-3)
            sp._events = None
            self._free += (start, stop)

    # -------------------------------------------------------------- export
    def __len__(self) -> int:
        return len(self._ring)

    def finished(self) -> List[Dict]:
        """Finished spans as dicts, oldest first."""
        return [s.to_dict() for s in self._ring]

    def iter_finished(self) -> Iterator[Dict]:
        return (s.to_dict() for s in self._ring)

    def clear(self) -> None:
        self._ring.clear()
        self._pending.clear()
        self._stack.clear()
        self.dropped = 0
        self.started = 0

    def meta(self) -> Dict:
        """The export header: ring accounting a reader needs to know
        whether the trace is complete (``dropped == 0``)."""
        return {"schema": 2, "dropped": self.dropped,
                "started": self.started, "exported": len(self._ring)}

    def export_jsonl(self, path) -> str:
        """Write the ring as JSON Lines (meta header first), its device
        spans resolved; returns the path written."""
        self.resolve()
        p = Path(path)
        if p.parent != Path(""):
            p.parent.mkdir(parents=True, exist_ok=True)
        with p.open("w") as f:
            f.write(json.dumps({"meta": self.meta()}) + "\n")
            for d in self.iter_finished():
                f.write(json.dumps(d) + "\n")
        return str(p)


def load_trace(path) -> Tuple[Optional[Dict], List[Dict]]:
    """Parse a trace file: returns ``(meta, spans)``.  ``meta`` is None for
    pre-schema-2 files (no header line)."""
    meta: Optional[Dict] = None
    spans: List[Dict] = []
    with Path(path).open() as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            if "meta" in d and "name" not in d:
                meta = d["meta"]
            else:
                spans.append(d)
    return meta, spans


def load_jsonl(path) -> List[Dict]:
    """Parse a trace file written by :meth:`Tracer.export_jsonl` (the meta
    header, when present, is skipped — use :func:`load_trace` to read it)."""
    return load_trace(path)[1]
