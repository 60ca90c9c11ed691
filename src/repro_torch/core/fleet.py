"""Vectorized fleet profile of the event-driven engine core.

:class:`~repro_torch.core.async_engine.FederatedBoostEngine` delegates here
when ``fleet=True`` (auto-enabled at ``FLEET_AUTO_CLIENTS``+ clients).  The
per-client profile runs one fit and one merge per learner — fine at 32
clients, hopeless at 100 000.  The fleet profile keeps the *same
event-queue semantics* but restructures the math:

* **Stacked shards on the card.**  Client shards are padded to the fleet's
  max rows and stacked into one ``(B, N, F)`` tensor; padding rows carry
  zero distribution mass, which the batched scan treats as "contributes
  nothing".  X, Y, the distributions D and the per-client threshold grids
  live on the engine's device, each built with one host-to-device copy
  (the grids by one ``stump_thresholds_batched`` pass there).
* **Deferred, batched fits.**  A client leg between syncs is causally
  closed, so its *timing* walk (availability/compute/stall/link draws — the
  behavior calls, in the reference call order) runs eagerly while the stump
  fits it implies are queued.  Pending fits resolve in dependency *waves* —
  wave ``j`` fits round ``j`` of every pending leg in one
  ``stump_scan_batched`` launch — and each wave's local eps/alpha/
  distribution updates run vectorized on the card.  The JAX package pads a
  wave to ``max(8, next_pow2(B))`` slots only to keep its compile cache
  small and slices the padding off; the kernel here takes any B, so a wave
  launches on its live slots alone, with the same results.
* **Server math on the host.**  Server-side re-weighting, the margin folds
  and the validation error are numpy on the host, as in the JAX package's
  own design (chunked so a 100k-learner round never materializes more than
  ``SERVER_CHUNK`` columns at once).  Every one of a 100k-client run's
  syncs feeds ``scheduler.observe`` on the host; on the card each would be
  about ten launches plus a blocking read.  The catch-up replays update D
  where it lives, on the card, with no read back.

Communication/time accounting is identical integer/float bookkeeping to
the per-client profile — byte counts, message counts, and simulated clocks
match exactly at equal seeds.  The distribution updates follow the JAX
package's fleet in f32, operation for operation; that reference is numpy,
so subnormal weights are kept here (the per-client engine flushes them, as
XLA does).  ``cfg.catch_up_cap`` bounds catch-up work per sync; ``None``
replays the whole window exactly like the per-client profile.

Only the ``stump`` weak learner is supported — the batched launch path is
stump-specific (the other learners never run at fleet scale).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import events
from repro_torch.core.buffers import BufferEntry, ENTRY_OVERHEAD_BYTES
from repro_torch.core.compensation import staleness_scale
from repro_torch.models.weak import stump_thresholds_batched

# server-side re-weighting materializes at most (n_val x SERVER_CHUNK)
SERVER_CHUNK = 4096
_F32 = np.float32
F32 = torch.float32


class FleetCore:
    """One engine run in the vectorized fleet profile."""

    def __init__(self, eng) -> None:
        if eng.weak.name != "stump" or eng.weak.fit_batched is None:
            raise ValueError(
                "the fleet profile batches stump fits; weak learner "
                f"{eng.weak.name!r} has no batched launch path")
        self.eng = eng
        self.cfg = eng.cfg
        self.m = eng.metrics
        self.clients = eng.clients
        self.dev = eng.device
        B = len(self.clients)

        # ---- stacked, padded shards (pad rows: x=0, y=0, D=0) ----
        self.n_valid = np.array([c.x.shape[0] for c in self.clients],
                                np.int32)
        N = int(self.n_valid.max())
        F = int(np.asarray(self.clients[0].x).shape[1])
        X = np.zeros((B, N, F), _F32)
        Y = np.zeros((B, N), _F32)
        D = np.zeros((B, N), _F32)
        for b, c in enumerate(self.clients):
            n = int(self.n_valid[b])
            X[b, :n] = np.asarray(c.x, _F32)
            Y[b, :n] = np.asarray(c.y, _F32)
            yb = Y[b, :n]
            if self.cfg.balanced_init:
                pos = (yb > 0).astype(_F32)
                npos = max(float(pos.sum()), 1.0)
                nneg = max(n - float(pos.sum()), 1.0)
                D[b, :n] = pos / (2 * npos) + (1 - pos) / (2 * nneg)
            else:
                D[b, :n] = 1.0 / n
        self.X = torch.from_numpy(X).to(self.dev)
        self.Y = torch.from_numpy(Y).to(self.dev)
        self.D = torch.from_numpy(D).to(self.dev)
        self.THR = stump_thresholds_batched(                   # (B, F, T)
            self.X, torch.from_numpy(self.n_valid).to(self.dev))
        self._all = np.arange(B)
        self._rows = torch.arange(N, device=self.dev)

        # ---- server state mirrors (numpy-side ensemble view) ----
        xv, yv = eng.data["val"]
        xt, yt = eng.data["test"]
        self.xv = np.asarray(xv.cpu(), _F32)
        self.yv = np.asarray(yv.cpu(), _F32)
        self.xt = np.asarray(xt.cpu(), _F32)
        self.yt = np.asarray(yt.cpu(), _F32)
        self.Mval = np.zeros(self.xv.shape[0], _F32)
        self.Mtest = np.zeros(self.xt.shape[0], _F32)
        # merged-learner columns, merge order (the catch-up window source)
        self._lf: List[int] = []       # feature
        self._lt: List[float] = []     # threshold
        self._lp: List[float] = []     # polarity
        self._la: List[float] = []     # compensated server alpha
        # deferred fits: cid -> FIFO of unresolved BufferEntry (insertion
        # order over cids is the wave's batch order)
        self._pending: Dict[int, List[BufferEntry]] = {}
        # stump wire size is params-independent, so accounting never needs
        # the (possibly still unresolved) params
        self._entry_bytes = (int(eng.weak.param_bytes(None))
                             + ENTRY_OVERHEAD_BYTES)

    # ------------------------------------------------------------ batched fits
    def _slot_index(self, slots: np.ndarray):
        """Device indices of ``slots``, or None for the whole fleet in
        order (the full tensors are used as they are, with no gather)."""
        if len(slots) == len(self._all) and np.array_equal(slots, self._all):
            return None
        return torch.from_numpy(slots).to(self.dev)

    def _fit_wave(self, slots: np.ndarray
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One batched-fit launch over ``slots`` (client rows), on the live
        slots only; returns (feature, threshold, polarity) on the card."""
        Bw = len(slots)
        idx = self._slot_index(slots)
        if idx is None:
            xb, yb, wb, tb = self.X, self.Y, self.D, self.THR
        else:
            xb, yb, wb, tb = (a.index_select(0, idx)
                              for a in (self.X, self.Y, self.D, self.THR))
        with obs.span("train.fit_batch", n_slots=Bw, padded=Bw):
            params = self.eng.weak.fit_batched(xb, yb, wb, tb)
        obs.count("train.fit_batches")
        obs.count("train.fits", Bw)
        return (params["feature"].long(), params["threshold"].to(F32),
                params["polarity"].to(F32))

    def _local_update(self, slots: np.ndarray, f: torch.Tensor,
                      thr: torch.Tensor, pol: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Vectorized mirror of the per-client ``_train_one`` tail, on the
        card in the JAX package's f32 order: eps on the pre-update
        distribution, the local alpha, and the eq.-(4) distribution update,
        for every fitted slot at once."""
        idx = self._slot_index(slots)
        if idx is None:
            idx = torch.arange(len(slots), device=self.dev)
        xsel = self.X[idx[:, None], self._rows[None, :], f[:, None]]
        h = pol[:, None] * torch.sign(xsel - thr[:, None] + 1e-12)
        yb, Db = self.Y[idx], self.D[idx]
        pred = torch.where(h > 0, 1.0, -1.0)
        eps = torch.sum(Db * (pred != yb), dim=1, dtype=F32)
        epsc = torch.clamp(eps, 1e-6, 1.0 - 1e-6)
        alpha = 0.5 * torch.log((1.0 - epsc) / epsc)
        w = Db * torch.exp(-alpha[:, None] * yb * h)
        Z = torch.sum(w, dim=1, dtype=F32)
        self.D[idx] = w / (Z[:, None] + 1e-30)
        return eps, alpha

    def _wave(self, slots: np.ndarray):
        """Fit ``slots`` and update their distributions; one copy to the
        host brings back (feature int64, threshold, polarity, eps, alpha),
        the last four as f32 numpy arrays."""
        f, thr, pol = self._fit_wave(slots)
        eps, alpha = self._local_update(slots, f, thr, pol)
        host = torch.stack([f.double(), thr.double(), pol.double(),
                            eps.double(), alpha.double()]).cpu().numpy()
        return (host[0].astype(np.int64),) + tuple(
            host[i].astype(_F32) for i in range(1, 5))

    def _defer_fit(self, c) -> BufferEntry:
        """Queue one deferred stump fit for client ``c``'s current round;
        the placeholder entry is filled in by the next resolution wave."""
        e = BufferEntry(None, 0.0, 0.0, c.local_round)
        c.local_round += 1
        self._pending.setdefault(c.cid, []).append(e)
        return e

    def _resolve_pending(self) -> None:
        """Drain every queued fit, one dependency wave at a time: wave j
        fits the j-th unresolved round of each pending client (each wave
        is a single batched launch)."""
        while self._pending:
            obs.get_registry().gauge("train.pending_fits").set(
                sum(len(v) for v in self._pending.values()))
            slots = np.fromiter(self._pending.keys(), np.int64,
                                len(self._pending))
            f, thr, pol, eps, alpha = self._wave(slots)
            for j, cid in enumerate(slots.tolist()):
                fifo = self._pending[cid]
                e = fifo.pop(0)
                e.params = {"feature": int(f[j]),
                            "threshold": float(thr[j]),
                            "polarity": float(pol[j])}
                e.eps = float(eps[j])
                e.alpha = float(alpha[j])
                if not fifo:
                    del self._pending[cid]
        obs.get_registry().gauge("train.pending_fits").set(0)

    # --------------------------------------------------------- server math
    def _merge_window(self, entries: List[BufferEntry], owners: List[int],
                      sync_round: int, compensated: bool) -> None:
        """Fold ``entries`` into the global ensemble: vectorized server
        re-weighting + margin folds, then the bookkeeping the per-client
        ``_merge`` does per entry."""
        if not entries:
            return
        eng, K = self.eng, len(entries)
        f = np.array([e.params["feature"] for e in entries], np.int64)
        thr = np.array([e.params["threshold"] for e in entries], _F32)
        pol = np.array([e.params["polarity"] for e in entries], _F32)
        a = np.empty(K, _F32)
        for lo in range(0, K, SERVER_CHUNK):
            s = slice(lo, min(lo + SERVER_CHUNK, K))
            a[s] = self._server_alphas(f[s], thr[s], pol[s])
        if compensated:
            scale = np.array(
                [staleness_scale(max(0, sync_round - e.round_stamp),
                                 self.cfg.compensation) for e in entries],
                _F32)
            a = a * scale
        for lo in range(0, K, SERVER_CHUNK):
            s = slice(lo, min(lo + SERVER_CHUNK, K))
            hv = pol[s] * np.sign(self.xv[:, f[s]] - thr[s] + 1e-12)
            ht = pol[s] * np.sign(self.xt[:, f[s]] - thr[s] + 1e-12)
            self.Mval += hv @ a[s]
            self.Mtest += ht @ a[s]
        for e, owner, ai in zip(entries, owners, a.tolist()):
            eng.ensemble.add(e.params, ai)
            eng._owners.append(owner)
            eng._round_stamps.append(e.round_stamp)
            self._lf.append(e.params["feature"])
            self._lt.append(e.params["threshold"])
            self._lp.append(e.params["polarity"])
            self._la.append(ai)
        self.m.learners_merged += K

    def _server_alphas(self, f: np.ndarray, thr: np.ndarray,
                       pol: np.ndarray) -> np.ndarray:
        """Vectorized ``_server_alpha``: validation-set re-weighting for a
        window of stump columns at once.  eps is taken in f64 (a mean of a
        bool mask, or an integer count over a Python float) and alpha cast
        to f32 only at the end, as in the JAX package's fleet."""
        h = pol[None, :] * np.sign(self.xv[:, f] - thr[None, :] + 1e-12)
        pred = np.where(h > 0, 1.0, -1.0).astype(_F32)
        yv = self.yv[:, None]
        miss = pred != yv
        if self.cfg.balanced_init:
            pos, neg = yv > 0, yv < 0
            ep = np.sum(miss & pos, axis=0) / max(float(pos.sum()), 1.0)
            en = np.sum(miss & neg, axis=0) / max(float(neg.sum()), 1.0)
            eps = np.clip(0.5 * (ep + en), 0.02, 0.98)
        else:
            eps = np.clip(miss.mean(axis=0), 0.02, 0.98)
        return (0.5 * np.log((1.0 - eps) / eps)).astype(_F32)

    def _val_err(self) -> float:
        pred = np.where(self.Mval > 0, 1.0, -1.0)
        return float(np.mean(pred != self.yv))

    # ----------------------------------------------------------- catch-up
    def _catch_up_fleet(self, w0: int, w1: int) -> None:
        """Every client replays the newest ``catch_up_cap`` foreign
        learners of window [w0, w1) into its local distribution — the
        whole fleet at once, one folded exponential per client (the
        baseline's per-round catch-up).  An owner-aware mask reproduces
        the per-client reverse scan: the window is extended by the largest
        per-owner multiplicity so every client finds ``cap`` foreign
        entries even when its own sit inside the candidate tail.  The mask
        is built on the host; the margins accumulate on the card over the
        candidates in order, in f32."""
        K = w1 - w0
        if K <= 0:
            return
        B = self.X.shape[0]
        cap = self.cfg.catch_up_cap
        owners = np.asarray(self.eng._owners[w0:w1], np.int64)
        if cap is None:
            W = K
        else:
            maxdup = int(np.bincount(owners - owners.min()).max()) if K else 0
            W = min(K, cap + maxdup)
        cand = slice(w1 - W, w1)              # oldest -> newest candidates
        co = np.asarray(self.eng._owners[cand.start:cand.stop], np.int64)
        foreign = co[None, :] != np.arange(B)[:, None]          # (B, W)
        if cap is None:
            sel = foreign
        else:
            rev = foreign[:, ::-1]
            sel = (rev & (np.cumsum(rev, axis=1) <= cap))[:, ::-1]
        sel = torch.from_numpy(np.ascontiguousarray(sel, _F32)).to(self.dev)
        cf = self._lf[cand.start:cand.stop]
        ct = self._lt[cand.start:cand.stop]
        cp = self._lp[cand.start:cand.stop]
        ca = self._la[cand.start:cand.stop]
        Macc = torch.zeros_like(self.D)
        for w in range(W):
            h = cp[w] * torch.sign(self.X[:, :, cf[w]] - ct[w] + 1e-12)
            Macc += (ca[w] * sel[:, w])[:, None] * h
        wgt = self.D * torch.exp(-self.Y * Macc)
        Z = torch.sum(wgt, dim=1, dtype=F32)
        self.D = wgt / (Z[:, None] + 1e-30)
        for c in self.clients:
            c.last_merged_idx = w1

    def _catch_up_client(self, c) -> None:
        """Per-client capped catch-up at its own sync (enhanced mode): the
        per-client reverse scan over [last_merged_idx, hi) skipping the
        client's own entries, folded into one exponential.  One copy to
        the card brings the window's columns; D[b] is updated where it
        lives, with no read back."""
        lo, hi = c.last_merged_idx, len(self._lf)
        cap = self.cfg.catch_up_cap
        owners = self.eng._owners
        if cap is None:
            idxs = [i for i in range(lo, hi) if owners[i] != c.cid]
        else:
            idxs = []
            i = hi - 1
            while i >= lo and len(idxs) < cap:
                if owners[i] != c.cid:
                    idxs.append(i)
                i -= 1
            idxs.reverse()
        c.last_merged_idx = hi
        if not idxs:
            return
        b = c.cid
        cols = np.array([[self._lf[i] for i in idxs],
                         [self._lt[i] for i in idxs],
                         [self._lp[i] for i in idxs],
                         [self._la[i] for i in idxs]], _F32)
        cols = torch.from_numpy(cols)
        if self.dev.type == "cuda":
            cols = cols.pin_memory().to(self.dev, non_blocking=True)
        f, thr, pol, a = cols[0].long(), cols[1], cols[2], cols[3]
        h = pol[None, :] * torch.sign(self.X[b][:, f] - thr[None, :] + 1e-12)
        wgt = self.D[b] * torch.exp(-self.Y[b] * (h @ a))
        # the JAX package's fleet takes Z to a Python float: the 1e-30 is
        # added in f64 and the divisor rounded to f32
        Z = torch.sum(wgt, dtype=F32).double() + 1e-30
        self.D[b] = wgt / Z.to(F32)

    # ---------------------------------------------------------------- run
    def run(self) -> None:
        if self.m.mode == "baseline":
            self._run_baseline()
        else:
            self._run_enhanced()
        # hand the accumulated margins back so the engine's _finalize /
        # _val_error see the fleet-computed state
        self.eng._val_margin = torch.from_numpy(self.Mval).to(self.dev)
        self.eng._test_margin = torch.from_numpy(self.Mtest).to(self.dev)

    def _run_baseline(self) -> None:
        """Synchronous baseline, fleet profile.  Same TRIGGER/BARRIER
        event structure as the per-client event core; per-message ARRIVAL
        events are folded into the barrier payload — the barrier consumes
        the round's messages in client order regardless, and a heap push
        per message at 100k clients buys nothing."""
        cfg, m, eng = self.cfg, self.m, self.eng
        vc = events.VirtualClock()
        B = self.X.shape[0]
        pending_late: List[Tuple[int, BufferEntry]] = []
        t = 0.0
        vc.push(0.0, events.TRIGGER, payload=0)
        while vc:
            ev = vc.pop()
            if ev.kind == events.TRIGGER:
                r, t0 = ev.payload, ev.t
                f, thr, pol, eps, alpha = self._wave(self._all)
                late, pending_late = pending_late, []
                on_time: List[Tuple[int, BufferEntry]] = []
                durations: List[float] = []
                for b, c in enumerate(self.clients):
                    dropped = not c.behavior.availability(t0)
                    dur = c.behavior.compute_time(eng.BASE_ROUND_S, t0)
                    e = BufferEntry(
                        {"feature": int(f[b]), "threshold": float(thr[b]),
                         "polarity": float(pol[b])},
                        float(eps[b]), float(alpha[b]), c.local_round)
                    c.local_round += 1
                    if dropped:
                        m.rounds_unavailable += 1
                        pending_late.append((b, e))
                        continue
                    up = self._entry_bytes + cfg.header_bytes
                    m.uplink_bytes += up
                    m.n_messages += 1
                    durations.append(
                        dur + c.behavior.link(t0).tx_time(up))
                    on_time.append((b, e))
                close = t0 + (max(durations) if durations
                              else eng.BASE_ROUND_S)
                vc.push(close, events.BARRIER, payload=(r, late, on_time))
            elif ev.kind == events.BARRIER:
                r, late, on_time = ev.payload
                t = ev.t
                for cid, e in late:
                    m.uplink_bytes += self._entry_bytes + cfg.header_bytes
                    m.n_messages += 1
                w0 = len(self._lf)
                batch = late + on_time
                self._merge_window([e for _, e in batch],
                                   [cid for cid, _ in batch],
                                   sync_round=r, compensated=False)
                delta = len(self._lf) - w0
                pkg = delta * 16 + cfg.header_bytes
                m.downlink_bytes += B * pkg
                m.n_messages += B
                self._catch_up_fleet(w0, len(self._lf))
                m.n_syncs += 1
                obs.count("train.syncs")
                obs.count("train.learners_merged", delta)
                eng._maybe_publish(t)
                eng._record(t, err=self._val_err())
                if r + 1 < cfg.n_rounds:
                    vc.push(t, events.TRIGGER, payload=r + 1)
        obs.count("train.events", vc.n_popped)
        m.sim_time_s = self._flush_late(pending_late, t)

    def _flush_late(self, pending_late: List[Tuple[int, BufferEntry]],
                    t: float) -> float:
        """Fleet mirror of the engine's ``_flush_late``: deliver + charge
        the final round's dropped messages, merge them stale-by-one at
        full weight, no downlink/sync tick."""
        cfg, m = self.cfg, self.m
        if not pending_late:
            return t
        t_flush = t
        for cid, e in pending_late:
            c = self.clients[cid]
            up = self._entry_bytes + cfg.header_bytes
            m.uplink_bytes += up
            m.n_messages += 1
            t_flush = max(t_flush, t + c.behavior.link(t).tx_time(up))
        self._merge_window([e for _, e in pending_late],
                           [cid for cid, _ in pending_late],
                           sync_round=cfg.n_rounds, compensated=False)
        if obs.enabled():
            obs.point("train.late_flush", sim_t0=t_flush,
                      n=len(pending_late))
        self.eng._record(t_flush, err=self._val_err())
        return t_flush

    def _run_enhanced(self) -> None:
        """The paper's algorithm, fleet profile: the per-client event loop
        with eager per-client timing walks and deferred, wave-batched
        fits.  Arrivals pop in the same (t, kind, cid) order; a payload
        still holding unresolved fits triggers a resolution sweep over
        *every* pending leg — at fleet scale many legs are in flight at
        once, so the sweep's waves stay large."""
        cfg, m, eng = self.cfg, self.m, self.eng
        vc = events.VirtualClock()
        for c in self.clients:
            c.known_interval = eng.scheduler.current
        finished = [False] * len(self.clients)

        def advance(c) -> None:
            trace = obs.enabled()
            while c.local_round < cfg.n_rounds:
                dropped = not c.behavior.availability(c.clock)
                e = self._defer_fit(c)
                c.clock += c.behavior.compute_time(eng.BASE_ROUND_S,
                                                   c.clock)
                if trace:
                    vc.push(c.clock, events.ROUND, c.cid)
                c.buffer.entries.append(e)
                if dropped:
                    m.rounds_unavailable += 1
                    c.clock += c.behavior.stall_time(eng.BASE_ROUND_S,
                                                     c.clock)
                    if trace:
                        vc.push(c.clock, events.STALL, c.cid)
                if len(c.buffer) >= c.known_interval:
                    if trace:
                        vc.push(c.clock, events.TRIGGER, c.cid)
                    arrival, payload = self._prepare_sync(c)
                    vc.push(arrival, events.ARRIVAL, c.cid, payload)
                    return
            finished[c.cid] = True
            if len(c.buffer):             # flush the tail buffer
                arrival, payload = self._prepare_sync(c)
                vc.push(arrival, events.ARRIVAL, c.cid, payload)

        for c in self.clients:
            advance(c)
        t = 0.0
        interval_gauge = obs.get_registry().gauge("train.interval")
        while vc:
            ev = vc.pop()
            if ev.kind == events.ROUND:
                obs.point("train.client_round", sim_t0=ev.t, cid=ev.cid)
                continue
            if ev.kind == events.STALL:
                obs.point("train.stall", sim_t0=ev.t, cid=ev.cid)
                continue
            if ev.kind == events.TRIGGER:
                obs.point("train.trigger", sim_t0=ev.t, cid=ev.cid)
                continue
            t, cid, payload = ev.t, ev.cid, ev.payload
            if any(e.params is None for e in payload):
                self._resolve_pending()
            c = self.clients[cid]
            sync_round = c.local_round - 1
            self._merge_window(payload, [cid] * len(payload),
                               sync_round=sync_round, compensated=True)
            m.n_syncs += 1
            obs.count("train.syncs")
            obs.count("train.learners_merged", len(payload))
            err = self._val_err()
            eng.scheduler.observe(err)
            delta = len(self._lf) - c.last_merged_idx
            pkg = delta * 16 + cfg.header_bytes
            m.downlink_bytes += pkg
            m.n_messages += 1
            self._catch_up_client(c)
            c.known_interval = eng.scheduler.current
            interval_gauge.set(eng.scheduler.current)
            eng._maybe_publish(t)
            eng._record(t, err=err)
            if not finished[cid]:
                advance(c)
        obs.count("train.events", vc.n_popped)
        m.sim_time_s = max(t, max(c.clock for c in self.clients))

    def _prepare_sync(self, c) -> Tuple[float, List[BufferEntry]]:
        """Fleet mirror of the engine's ``_prepare_sync``.  The relevance
        filter needs the buffered alphas, so an enabled filter forces the
        pending fits to resolve first (the filter is off in the shipped
        fleet scenarios — it would serialize the waves)."""
        cfg, m = self.cfg, self.m
        if cfg.relevance_filter > 0 and len(c.buffer) > 1:
            if any(e.params is None for e in c.buffer.entries):
                self._resolve_pending()
            now = c.local_round - 1
            entries = c.buffer.entries
            w = [abs(e.alpha) * staleness_scale(
                    max(0, now - e.round_stamp), cfg.compensation)
                 for e in entries]
            cut = cfg.relevance_filter * max(w)
            kept = [e for e, wi in zip(entries, w) if wi >= cut]
            c.buffer.entries = kept if kept else entries[-1:]
        nbytes = (len(c.buffer) * self._entry_bytes + cfg.header_bytes)
        payload = c.buffer.flush()
        arrival = c.clock + c.behavior.link(c.clock).tx_time(nbytes)
        m.uplink_bytes += nbytes
        m.n_messages += 1
        return arrival, payload
