"""Mesh-integrated federated async boosting: the paper's technique as one
step over every client at once.

The JAX package compiles the step as a ``shard_map`` over a client mesh
axis.  Here the client axis is dim 0 of every client-sharded tensor
(``D``, the buffers, ``val_margin`` and the data), in one of two forms:

* one process holds every client: ``all_gather(tiled=True)`` is the flat
  view of dim 0, ``psum`` a sum over dim 0 and ``axis_index`` the client's
  row — what ``shard_map`` computes when one device holds every client;
* a ``torch.distributed`` process group: each rank holds K/world
  consecutive clients, the buffers are gathered over the group
  (``all_gather_into_tensor``, NCCL's own gather) and the sums reduced
  over it.  Every summed quantity is a count held in f32, so the group
  gives the one-process run's bits.  It runs over gloo on the CPU (2 and
  4 ranks in the tests) and over NCCL on a card (one rank: every client
  on the one card, through the same gathers and sums a group of four
  cards would take; four cards are not run yet).  The gathered buffers
  are f32 and int32 and the sums f32, all types NCCL has; the
  collectives run on the current stream's order, as the kernels do.

Everything the paper schedules runs in :func:`make_fed_boost_step`'s step:

* one boosting round on every client: the K stump fits are one
  ``stump_scan_batched`` launch (:mod:`repro_torch.kernels.ops`), picked
  by the JAX package's rule (``models.weak._pick_stump_batched``), and the
  local eq.-(4) update;
* the sync, when ``counter - last_sync >= floor(I_t)``: the fixed-capacity
  buffers gathered over the clients (weak-learner traffic only), the
  server alpha from the global validation error of every gathered stump,
  eq.-(2) compensation, the fold into the replicated ensemble (entries past
  its capacity dropped, as the reference's ``mode="drop"`` scatter drops
  them), the foreign learners' update of each client's distribution and the
  running validation margin — both α-weighted sums over the gathered stumps
  through ``stump_vote_batched`` — and eq. (1) on the new global error.

The reference's ``lax.cond(due, sync, identity)`` is a host branch: the
round counters are host ints, and the scheduler's interval and previous
error are f32 scalar tensors on the host, updated once a sync from the
global error.  So a round reads nothing back from the card, and a sync one
scalar.

The reference multiplies the foreign learners' M factors
``exp(-α_m·y·mx_m)``; the port takes the exponential of their sum, which
the vote kernel computes in one launch (the two agree to a few f32 ulps of
each factor: ``tests/test_torch_fed_mesh.py`` states the tolerance).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.configs.paper_fedboost import FedBoostConfig
from repro_torch.core import scheduling
from repro_torch.core.compensation import adaboost_alpha, compensate
from repro_torch.kernels import ops as kops
from repro_torch.models.weak import _pick_stump_batched

F32 = torch.float32
I32 = torch.int32
TINY = torch.finfo(F32).tiny        # the least normal f32
Tensor = torch.Tensor


class FedMeshState(NamedTuple):
    """The reference's state, field for field.  Leaves with a leading
    client axis are split over the clients (:func:`state_shardings`); the
    round counters are host ints and the interval and previous error f32
    scalar tensors on the host, so the due test reads nothing back."""
    # per-client (leading axis = clients)
    D: Tensor                # (K, n_local) sample distributions
    buf_params: Tensor       # (K, cap, 4) feature,thr,polarity,local_eps
    buf_stamp: Tensor        # (K, cap) int32 round trained
    buf_count: Tensor        # (K,) int32 entries in buffer
    # replicated ensemble
    ens_params: Tensor       # (T_cap, 4)
    ens_alpha: Tensor        # (T_cap,)
    ens_count: int
    # margins of the ensemble on each client's validation slice
    val_margin: Tensor       # (K, n_val_local)
    # controller
    interval: Tensor         # () f32, host
    prev_err: Tensor         # () f32, host
    counter: int             # rounds done
    last_sync: int
    sync_count: int
    key: int                 # the run's seed; the step draws nothing


def init_state(cfg: FedBoostConfig, n_clients: int, n_local: int,
               n_val_local: int, buffer_cap: int, ens_cap: int,
               key: int = 0, device="cuda") -> FedMeshState:
    """The state before round 0.  ``n_clients`` is the clients this
    process holds (K/world in a process group)."""
    from repro_torch.device import resolve_device
    dev = resolve_device(device)
    sch = scheduling.init_state(cfg.scheduler)
    return FedMeshState(
        D=torch.full((n_clients, n_local), 1.0 / n_local, dtype=F32,
                     device=dev),
        buf_params=torch.zeros((n_clients, buffer_cap, 4), dtype=F32,
                               device=dev),
        buf_stamp=torch.zeros((n_clients, buffer_cap), dtype=I32,
                              device=dev),
        buf_count=torch.zeros((n_clients,), dtype=I32, device=dev),
        ens_params=torch.zeros((ens_cap, 4), dtype=F32, device=dev),
        ens_alpha=torch.zeros((ens_cap,), dtype=F32, device=dev),
        ens_count=0,
        val_margin=torch.zeros((n_clients, n_val_local), dtype=F32,
                               device=dev),
        interval=sch.interval, prev_err=sch.prev_error,
        counter=0, last_sync=0, sync_count=0, key=int(key))


def fit_clients(x: Tensor, y: Tensor, D: Tensor, thresholds: Tensor,
                policy=None) -> Tuple[Tensor, Tensor]:
    """Every client's least-error stump in one ``stump_scan_batched``
    launch: x (K,n,F), y/D (K,n), thresholds (K,F,T) -> (params (K,4) as
    (feature, threshold, polarity, eps), eps (K,)).  The function is the
    reference's ``_fit_stump_local`` einsum per client, the pick its rule;
    eps is the chosen polarity's error in f32."""
    err = kops.stump_scan_batched(x, y, D, thresholds, policy=policy)
    p = _pick_stump_batched(err, thresholds)
    params = torch.stack([p["feature"].to(F32), p["threshold"],
                          p["polarity"], p["eps"]], dim=1)
    return params, p["eps"]


def _flush(t: Tensor) -> Tensor:
    """Subnormal weights to zero, as the reference's compiled update
    leaves them (the weights are >= 0)."""
    return t.masked_fill(t < TINY, 0.0)


def _normalize(w: Tensor) -> Tensor:
    w = _flush(w)
    return _flush(w / (torch.sum(w, dim=1, keepdim=True) + 1e-30))


class _OneProcess:
    """Every client in this process: the collectives act on dim 0."""
    offset = 0

    def gather(self, t: Tensor) -> Tensor:
        return t

    def psum(self, t: Tensor) -> Tensor:
        return t.sum(0)


class _Group:
    """K/world consecutive clients a rank, rank r holding clients
    ``[r·K/world, (r+1)·K/world)``: gathers concatenate the ranks' dim 0
    in rank order, sums reduce over the group."""

    def __init__(self, group, n_local_clients: int):
        import torch.distributed as dist
        self.dist, self.group = dist, group
        self.world = dist.get_world_size(group)
        self.offset = dist.get_rank(group) * n_local_clients

    def gather(self, t: Tensor) -> Tensor:
        t = t.contiguous()
        out = t.new_empty((self.world * t.shape[0],) + tuple(t.shape[1:]))
        self.dist.all_gather_into_tensor(out, t, group=self.group)
        return out

    def psum(self, t: Tensor) -> Tensor:
        s = t.sum(0)
        self.dist.all_reduce(s, group=self.group)
        return s


def _stump_margins(xsel: Tensor, thr: Tensor, pol: Tensor) -> Tensor:
    """pol·sign(x − thr + 1e-12): xsel (K,M,n), thr/pol (M,) -> (K,M,n)."""
    return pol[None, :, None] * torch.sign(xsel - thr[None, :, None] + 1e-12)


def make_fed_boost_step(cfg: FedBoostConfig, thresholds: Tensor, *,
                        group=None, fit: Optional[Callable] = None,
                        policy=None):
    """The federated-boosting round.

    Returns ``step(state, x, y, xv, yv) -> state`` where x, y are the
    (K, n, F)/(K, n) client shards and xv, yv the (K, n_val, F)/(K, n_val)
    validation slices, K the clients this process holds:
    ``cfg.n_clients``, or ``cfg.n_clients / world`` in a
    ``torch.distributed`` ``group``.  ``thresholds`` (F,T) is expanded to
    every client once, here.  ``fit`` replaces :func:`fit_clients` (same
    signature, ``policy`` excluded) for replays handed another run's
    stumps; ``policy`` is the kernel dispatcher's.
    """
    sch = cfg.scheduler
    comp = cfg.compensation
    if group is None:
        coll = _OneProcess()
        k_local = cfg.n_clients
    else:
        import torch.distributed as dist
        world = dist.get_world_size(group)
        if cfg.n_clients % world:
            raise ValueError(f"{cfg.n_clients} clients over {world} ranks")
        k_local = cfg.n_clients // world
        coll = _Group(group, k_local)
    F, T = thresholds.shape
    thr_k = thresholds.to(F32).expand(k_local, F, T).contiguous()
    fit = fit or (lambda x, y, D, thr: fit_clients(x, y, D, thr, policy))

    def local_round(state: FedMeshState, x, y) -> FedMeshState:
        """One boosting round on every client (no communication)."""
        params, eps = fit(x, y, state.D, thr_k)
        rows = torch.arange(x.shape[0], device=x.device)
        xf = x[rows, :, params[:, 0].long()]                     # (K, n)
        margins = params[:, 2:3] * torch.sign(xf - params[:, 1:2] + 1e-12)
        a = adaboost_alpha(eps)
        D = _normalize(state.D * torch.exp(-a[:, None] * y * margins))
        # every client appends once a round and a sync empties every
        # buffer, so the ring slot is the same host int for all of them
        slot = (state.counter - state.last_sync) % state.buf_params.shape[1]
        bufp = state.buf_params.clone()
        bufs = state.buf_stamp.clone()
        bufp[:, slot] = params
        bufs[:, slot] = state.counter
        return state._replace(D=D, buf_params=bufp, buf_stamp=bufs,
                              buf_count=state.buf_count + 1,
                              counter=state.counter + 1)

    def sync(state: FedMeshState, x, y, xv, yv) -> FedMeshState:
        """Synchronization event: gather buffers, compensate, merge, update
        distributions and the adaptive interval."""
        k, cap = state.buf_params.shape[:2]
        dev = state.D.device
        # ---- collective: buffers cross the client axis here ----
        flat_p = coll.gather(state.buf_params).reshape(-1, 4)   # (M, 4)
        flat_s = coll.gather(state.buf_stamp).reshape(-1)       # (M,)
        M = flat_p.shape[0]
        n_buf = min(state.counter - state.last_sync, cap)
        valid = (torch.arange(cap, device=dev) < n_buf).repeat(M // cap)
        # ownership: a client's own learners were applied to its local
        # distribution at training time — skip them in the merged update
        owner = torch.arange(M // cap, device=dev).repeat_interleave(cap)
        mine = coll.offset + torch.arange(k, device=dev)
        foreign = valid[None, :] & (owner[None, :] != mine[:, None])

        feat = flat_p[:, 0].long()
        thr, pol = flat_p[:, 1].contiguous(), flat_p[:, 2].contiguous()
        # server alpha on the global validation distribution: miss counts
        # on the local slices, summed over the clients
        xv_sel = xv[:, :, feat].transpose(1, 2)                  # (K, M, nv)
        mv = _stump_margins(xv_sel, thr, pol)
        local_miss = torch.sum((torch.where(mv > 0, 1.0, -1.0)
                                != yv[:, None, :]).to(F32), dim=2)
        miss = coll.psum(local_miss)                             # (M,)
        n_val = coll.psum(torch.full((k,), float(yv.shape[1]), dtype=F32,
                                     device=dev))
        alpha = adaboost_alpha(torch.clamp(miss / n_val, 0.02, 0.98))
        tau = (state.counter - flat_s).to(F32)
        alpha_t = torch.where(valid, compensate(alpha, tau, comp), 0.0)

        # fold into the replicated ensemble; entries past its capacity go
        # to a spare row that is cut off again (the reference's drop)
        cap_t = state.ens_params.shape[0]
        pos = state.ens_count + torch.cumsum(valid.to(torch.int64), 0) - 1
        pos = torch.where(valid & (pos < cap_t), pos, cap_t)
        ens_p = torch.cat([state.ens_params, state.ens_params[:1]])
        ens_a = torch.cat([state.ens_alpha, state.ens_alpha[:1]])
        ens_p = ens_p.index_copy(0, pos, flat_p)[:cap_t]
        ens_a = ens_a.index_copy(0, pos, alpha_t)[:cap_t]

        thr_b, pol_b = thr.expand(k, M), pol.expand(k, M)
        # the foreign learners' update of each local distribution:
        # D·exp(−y·Σ_m [valid ∧ foreign]·α_m·mx_m), one vote launch
        xsel = x[:, :, feat].transpose(1, 2)                     # (K, M, n)
        a_use = torch.where(foreign, alpha_t[None, :], 0.0)
        s = kops.stump_vote_batched(xsel, thr_b, pol_b, a_use,
                                    policy=policy)
        D = _normalize(state.D * torch.exp(-y * s))

        # the running validation margin and the global error
        a_val = alpha_t.expand(k, M)
        val_margin = state.val_margin + kops.stump_vote_batched(
            xv_sel, thr_b, pol_b, a_val, policy=policy)
        loc_err = torch.sum((torch.where(val_margin > 0, 1.0, -1.0)
                             != yv).to(F32), dim=1)
        g_err = (coll.psum(loc_err) / n_val).cpu()   # the sync's one read

        # adaptive interval (eq. 1) on the new global error
        st = scheduling.adapt_interval(
            scheduling.SchedulerState(state.interval, state.prev_err, True),
            g_err, sch)
        return state._replace(
            D=D,
            buf_params=torch.zeros_like(state.buf_params),
            buf_stamp=torch.zeros_like(state.buf_stamp),
            buf_count=torch.zeros_like(state.buf_count),
            ens_params=ens_p, ens_alpha=ens_a,
            ens_count=state.ens_count + (M // cap) * n_buf,
            val_margin=val_margin,
            interval=st.interval, prev_err=st.prev_error,
            last_sync=state.counter,
            sync_count=state.sync_count + 1)

    def step(state: FedMeshState, x, y, xv, yv) -> FedMeshState:
        state = local_round(state, x, y)
        if state.counter - state.last_sync >= int(torch.floor(state.interval)):
            state = sync(state, x, y, xv, yv)
        return state

    return step


def publish_snapshot(state: FedMeshState, registry, tenant: str, *,
                     clock: float = 0.0):
    """Snapshot the replicated ensemble of a (possibly mid-training)
    :class:`FedMeshState` into a serving
    :class:`~repro_torch.serve.registry.EnsembleRegistry`, or into a
    :class:`~repro_torch.serve.shard.ShardCluster`, whose ``publish_packed``
    routes it to the tenant's owning shard.  ``ens_params`` is already the
    packed (T, 4) stump wire format, so this is a copy to the host and a
    slice."""
    n = int(state.ens_count)
    params = state.ens_params[:n].cpu()
    alphas = state.ens_alpha[:n].cpu()
    with obs.span("train.publish", sim_t=clock, tenant=tenant,
                  n_learners=n) as sp:
        snap = registry.publish_packed(
            tenant, params, alphas, clock=float(clock),
            train_progress=int(state.counter))
        sp.set(version=getattr(snap, "version", None))
        sp.end_sim(clock)
    obs.count("train.publishes")
    return snap


def state_shardings(client_axis: str = "clients") -> FedMeshState:
    """Which leaves are split over the clients: ``client_axis`` for a
    leaf whose dim 0 is the client axis, None for a replicated one (the
    reference's ``P(client_axis)`` and ``P()``)."""
    c, r = client_axis, None
    return FedMeshState(
        D=c, buf_params=c, buf_stamp=c, buf_count=c,
        ens_params=r, ens_alpha=r, ens_count=r,
        val_margin=c, interval=r, prev_err=r, counter=r,
        last_sync=r, sync_count=r, key=r)
