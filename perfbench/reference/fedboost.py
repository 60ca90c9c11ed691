"""The plain mesh-integrated federated boost, written from the paper's
equations, for judging what the timed window produced.

It imports no kernel and nothing of the measured program, and works in the
precision the configuration states, f32, with its sums and each
distribution's update taken in f64 and rounded once.  A federation of K
clients and buffers of ``cap`` slots:

* every round each client fits the stump of least weighted error over the
  shared (feature, threshold) grid and both polarities: x > threshold
  predicts +1; the negative polarity's error is 1 minus the positive one's;
  the first least cell in row-major order wins, polarity +1 on a tie, and a
  NaN error counts as least (``torch.argmin``'s rule).  alpha =
  1/2 ln((1 - eps)/eps), eps clipped to [1e-6, 1 - 1e-6]; eq. (4):
  D <- D exp(-alpha y h) / sum, where h = pol sign(x - thr + 1e-12),
  worked out in log space, so that it is the normalised weight whatever the
  size of the exponent, and a weight below the least normal f32 counts as 0.
  The stump goes to ring slot ``(counter - last_sync) % cap``, stamped with
  the round;
* after the round, when ``counter - last_sync >= floor(I)``, a sync over
  the first n_buf = min(counter - last_sync, cap) slots of every client:
  each stump's server alpha is that of its miss rate over every validation
  row, clipped to [0.02, 0.98]; eq. (2) scales it by s(counter - stamp);
  the stumps and their scaled alphas are folded into the ensemble in
  client-major, slot-minor order; each client's distribution is updated by
  eq. (4) with the scaled vote of every other client's stumps; the vote of
  all of them is added to each validation margin; the share of validation
  rows whose margin's sign (> 0 is +1) misses the label is the global
  error, and eq. (1) on it (the previous error starting at 1) sets the next
  interval.  The buffers are emptied.

The dynamics are chaotic: a row permutation of the data changes the rounding
of a sum, a stump tie, and from there the whole schedule.  So the judge
follows the record step by step (``judge``): it checks the recorded start,
then computes each round again from the recorded state before it, and
measures what the record holds after it against that.  Where the round's
stumps are a choice, it measures how far each recorded stump's error lies
above the least one, and goes on with the recorded stump; where the global
error is a count of margins' signs, it checks the recorded count against
its own margins and goes on with the recorded error.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

F32 = torch.float32
F64 = torch.float64
EPS_CLIP = 1e-6
# validation rows whose margin lies within this share of 1 + the l1 norm of
# the sync's alphas of zero may be read with either sign by the global error
MARGIN_BAND = 1e-4


def staleness_scale(tau: torch.Tensor, comp: Dict) -> torch.Tensor:
    """s(tau) of eq. (2) and the FedAsync family, tau clamped to
    [0, tau_cap]."""
    tau = tau.clamp(0.0, float(comp["tau_cap"]))
    decay = comp["decay"]
    if decay == "exp":
        return torch.exp(-comp["lam"] * tau)
    if decay == "constant":
        return torch.ones_like(tau)
    if decay == "hinge":
        return torch.where(tau <= comp["hinge_b"], 1.0,
                           1.0 / (comp["hinge_a"] * (tau - comp["hinge_b"])
                                  .clamp(min=EPS_CLIP)))
    if decay == "poly":
        return (tau + 1.0) ** (-comp["poly_a"])
    raise KeyError(f"unknown staleness decay {decay!r}")


def _f32(v: float) -> float:
    return float(torch.tensor(v, dtype=F32))


def next_interval(interval: float, err: float, prev: float,
                  sch: Dict) -> float:
    """Eq. (1) on the observed global error, in f32."""
    de = _f32(_f32(err) - _f32(prev))
    if de < _f32(sch["theta1"]):
        interval = interval + sch["alpha"]
    elif de > _f32(sch["theta2"]):
        interval = max(1.0, interval - sch["beta"])
    return min(max(interval, float(sch["i_min"])), float(sch["i_max"]))


class Fed:
    """The federation's inputs and steps in ``dtype`` on ``device``."""

    def __init__(self, inputs, settings: Dict, dtype=F32, device="cpu",
                 block_bytes: float = 1e9):
        x, y, xv, yv, thr = (torch.as_tensor(a) for a in inputs)
        self.dt, self.dev = dtype, torch.device(device)
        self.acc = F64 if dtype == F32 else dtype
        d = dict(device=self.dev, dtype=dtype)
        self.x, self.y = x.to(**d), y.to(**d)
        self.xv, self.yv = xv.to(**d), yv.to(**d)
        self.thr32 = thr.to(self.dev, F32)
        self.thr = self.thr32.to(dtype)
        self.K, self.n, self.F = x.shape
        self.nv, self.T = xv.shape[1], thr.shape[1]
        self.sch, self.comp = settings["scheduler"], settings["compensation"]
        self.cap = settings["buffer_cap"]
        self.tiny = torch.finfo(dtype).tiny
        self.block = max(1, int(block_bytes // (
            8 * self.K * self.cap * max(self.n, self.nv))))
        self.rows = max(1, int(block_bytes // (8 * self.K * self.F * self.T)))

    def init(self) -> Dict:
        K, cap, z = self.K, self.cap, dict(device=self.dev)
        i0 = min(max(float(self.sch["i_init"]), float(self.sch["i_min"])),
                 float(self.sch["i_max"]))
        return {"D": torch.full((K, self.n), 1.0 / self.n, dtype=self.dt,
                                **z),
                "buf_params": torch.zeros((K, cap, 4), dtype=F32, **z),
                "buf_stamp": torch.zeros((K, cap), dtype=torch.long, **z),
                "buf_count": torch.zeros((K,), dtype=torch.long, **z),
                "val_margin": torch.zeros((K, self.nv), dtype=self.dt, **z),
                "interval": i0, "prev_err": 1.0, "counter": 0,
                "last_sync": 0, "sync_count": 0, "ens_count": 0}

    def _flush(self, w):
        return w.masked_fill(w < self.tiny, 0.0)

    def _eq4(self, D, v):
        """normalise(D exp(v)) a row, in log space in the working
        precision's accumulator: no exponent overflows."""
        lw = torch.log(D.to(self.acc)) + v.to(self.acc)
        top = lw.amax(1, keepdim=True)
        w = torch.exp(lw - torch.where(torch.isfinite(top), top, 0.0))
        w = w / w.sum(1, keepdim=True).clamp_min(torch.finfo(self.acc).tiny)
        return self._flush(w.to(self.dt))

    @staticmethod
    def _margins(xsel, thr, pol):
        return pol * torch.sign(xsel - thr + 1e-12)

    def errors(self, D) -> torch.Tensor:
        """(K, F*T) weighted error of every polarity-+1 stump."""
        # a row misses where (x > thr) differs from (y > 0): its weight
        # counts once for y > 0, minus once more where x > thr, and once
        # for y <= 0 where x > thr
        w = D.to(self.acc)
        pos = self.y > 0
        err = (w * pos).sum(1)[:, None, None].expand(
            self.K, self.F, self.T).clone()
        sign = torch.where(pos, -w, w)
        for r0 in range(0, self.n, self.rows):
            rb = slice(r0, r0 + self.rows)
            above = (self.x[:, rb, :, None] > self.thr[None, None]).to(
                self.acc)
            err += torch.einsum("kr,krft->kft", sign[:, rb], above)
        return err.to(self.dt).reshape(self.K, -1)

    def fit(self, D):
        """Every client's (feature, grid column, polarity) by the pick
        rule, the error grids of both polarities and the least error."""
        e_pos = self.errors(D)
        e_neg = 1.0 - e_pos
        ip, ineg = e_pos.argmin(1), e_neg.argmin(1)
        bp = e_pos.gather(1, ip[:, None])[:, 0]
        bn = e_neg.gather(1, ineg[:, None])[:, 0]
        take = bp <= bn
        cell = torch.where(take, ip, ineg)
        return (cell // self.T, cell % self.T, torch.where(take, 1, -1),
                e_pos, e_neg, torch.minimum(bp, bn))

    def step(self, S: Dict, pick: Optional[Dict] = None) -> Dict:
        """The round after state ``S``: the fit (or ``pick``: ``f``, ``t``,
        ``pol`` and the ``params`` row to buffer), the local update and, when
        due, the sync.  Returns the next ``state``, the stumps' ``eps``,
        the clients' ``least`` error, and on a sync what ``sync``
        returns."""
        K, cap, dt = self.K, self.cap, self.dt
        f, t, pol, e_pos, e_neg, least = self.fit(S["D"].to(dt))
        if pick is not None:
            f, t, pol = pick["f"], pick["t"], pick["pol"]
        cell = (f * self.T + t)[:, None]
        eps = torch.where(pol > 0, e_pos.gather(1, cell)[:, 0],
                          e_neg.gather(1, cell)[:, 0])
        e = eps.clamp(EPS_CLIP, 1.0 - EPS_CLIP)
        a = 0.5 * torch.log((1.0 - e) / e)
        rows = torch.arange(K, device=self.dev)
        m = self._margins(self.x[rows, :, f], self.thr[f, t][:, None],
                          pol.to(dt)[:, None])
        D = self._eq4(S["D"].to(dt), -a[:, None] * self.y * m)
        # a buffered stump: its feature, its grid threshold, its polarity
        # and its error, in f32 whatever the working precision
        params = torch.stack([f.to(F32), self.thr32[f, t], pol.to(F32),
                              eps.to(F32)], 1)
        if pick is not None:
            params = pick["params"].to(F32)
        slot = (S["counter"] - S["last_sync"]) % cap
        bufp = S["buf_params"].to(F32).clone()
        bufs = S["buf_stamp"].long().clone()
        bufp[:, slot], bufs[:, slot] = params, S["counter"]
        N = dict(S, D=D, buf_params=bufp, buf_stamp=bufs,
                 buf_count=S["buf_count"].long() + 1,
                 counter=S["counter"] + 1)
        out = {"state": N, "eps": eps, "least": least}
        if N["counter"] - N["last_sync"] >= math.floor(N["interval"]):
            out.update(self.sync(N))
        return out

    def sync(self, S: Dict) -> Dict:
        """The sync after a round.  Returns the next ``state``, the fold's
        ``block`` of stumps and their ``alpha``, the l1 norm of the alphas
        (``vm_l1``) and the validation margins (``vm``)."""
        K, cap, dt, acc = self.K, self.cap, self.dt, self.acc
        n_buf = min(S["counter"] - S["last_sync"], cap)
        flat = S["buf_params"].reshape(-1, 4)
        stamp = S["buf_stamp"].reshape(-1)
        valid = (torch.arange(cap, device=self.dev) < n_buf).repeat(K)
        owner = torch.arange(K, device=self.dev).repeat_interleave(cap)
        f = flat[:, 0].nan_to_num(0.0).long().clamp(0, self.F - 1)
        thr, pol = flat[:, 1].to(dt), flat[:, 2].to(dt)
        miss = torch.zeros(f.shape, dtype=acc, device=self.dev)
        for k0 in range(0, K, self.block):
            kb = slice(k0, k0 + self.block)
            mv = self._margins(self.xv[kb][:, :, f], thr, pol)  # (b, nv, M)
            pred = torch.where(mv > 0, 1.0, -1.0)
            miss += (pred != self.yv[kb][:, :, None]).to(acc).sum((0, 1))
        rate = (miss.to(dt) / (K * self.nv)).clamp(0.02, 0.98)
        alpha = 0.5 * torch.log((1.0 - rate) / rate)
        tau = (S["counter"] - stamp).to(dt)
        alpha_t = torch.where(valid, alpha * staleness_scale(tau, self.comp),
                              0.0).to(dt)
        D, vm = S["D"].clone(), S["val_margin"].to(dt).clone()
        for k0 in range(0, K, self.block):
            kb = slice(k0, k0 + self.block)
            ks = torch.arange(k0, min(k0 + self.block, K), device=self.dev)
            a_use = torch.where(owner[None, :] != ks[:, None],
                                alpha_t[None, :], 0.0)
            mx = self._margins(self.x[kb][:, :, f], thr, pol)   # (b, n, M)
            s = (mx.to(acc) * a_use[:, None, :].to(acc)).sum(-1).to(dt)
            D[kb] = self._eq4(D[kb], -self.y[kb] * s)
            mv = self._margins(self.xv[kb][:, :, f], thr, pol)
            vm[kb] = vm[kb] + (mv.to(acc) * alpha_t.to(acc)).sum(-1).to(dt)
        wrong = int((torch.where(vm > 0, 1.0, -1.0) != self.yv).sum())
        err = _f32(_f32(wrong) / _f32(K * self.nv))
        N = dict(S, D=D, val_margin=vm,
                 buf_params=torch.zeros_like(S["buf_params"]),
                 buf_stamp=torch.zeros_like(S["buf_stamp"]),
                 buf_count=torch.zeros_like(S["buf_count"]),
                 interval=next_interval(S["interval"], err, S["prev_err"],
                                        self.sch),
                 prev_err=err, last_sync=S["counter"],
                 sync_count=S["sync_count"] + 1,
                 ens_count=S["ens_count"] + K * n_buf)
        return {"state": N, "block": flat[valid], "alpha": alpha_t[valid],
                "vm_l1": float(alpha_t.abs().sum()), "vm": vm}


# ------------------------------------------------------------------ judge
def _gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest absolute gap; inf where a value on either side is not
    finite or the shapes differ."""
    got, want = got.to(F64), want.to(got.device, F64)
    if got.shape != want.shape or not (
            bool(torch.isfinite(got).all()) and
            bool(torch.isfinite(want).all())):
        return math.inf
    return float((got - want).abs().max()) if got.numel() else 0.0


def _d_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest gap of a distribution weight over its client's largest
    weight in the reference."""
    if got.shape != want.shape:
        return math.inf
    scale = want.to(F64).abs().amax(1, keepdim=True).clamp_min(1e-30)
    return _gap(got.to(F64) / scale, want.to(F64) / scale)


def _bits_differ(got: torch.Tensor, want: torch.Tensor) -> int:
    """1 unless the two hold the same f32 bits."""
    got = got.to(F32).contiguous()
    want = want.to(got.device, F32).contiguous()
    return int(got.shape != want.shape or not torch.equal(
        got.view(torch.int32), want.view(torch.int32)))


def _nonfinite(state: Dict) -> int:
    """Values of a recorded state that are NaN or infinite."""
    n = sum(int((~torch.isfinite(state[k].to(F64))).sum())
            for k in ("D", "val_margin", "buf_params")
            + (("alpha",) if "alpha" in state else ()))
    return n + sum(not math.isfinite(float(state[k]))
                   for k in ("interval", "prev_err"))


def _parse(params: torch.Tensor, thr32: torch.Tensor):
    """Recorded (K, 4) stump rows as (feature, grid column, polarity), and
    the rows that name no stump of the grid."""
    F, T = thr32.shape
    feat = params[:, 0]
    ok = torch.isfinite(feat) & (feat == feat.round()) & (feat >= 0) & \
        (feat < F) & ((params[:, 2] == 1.0) | (params[:, 2] == -1.0))
    f = torch.where(ok, feat, 0.0).long()
    hit = thr32[f].view(torch.int32) == params[:, 1:2].contiguous().view(
        torch.int32)
    ok &= hit.any(1)
    return (f, hit.to(torch.int8).argmax(1),
            torch.where(params[:, 2] > 0, 1, -1), ~ok)


def judge(record: Dict, inputs, settings: Dict, device="cpu") -> Dict:
    """The numbers that decide ``correct`` for one recorded federation.

    ``record["states"]`` holds the federation's states from the start: the
    program's ``D``, ``buf_params``, ``buf_stamp``, ``buf_count``,
    ``val_margin``, ``interval``, ``prev_err``, ``counter``, ``last_sync``,
    ``sync_count`` and ``ens_count``, and after a sync the ``block`` of
    stumps the round folded into the ensemble and their ``alpha``;
    ``record["ens_params"]`` and ``record["ens_alpha"]`` are the last
    state's whole ensemble.

    Returns ``pick_gap`` (the largest error of a recorded stump above its
    client's least one, and of a recorded eps off that stump's error, in
    weight), ``d_gap`` (the largest gap of a distribution weight, over
    its client's largest weight),
    ``alpha_gap`` (of a folded scaled alpha), ``margin_gap`` (of a
    validation margin, over 1 + the l1 norm of the sync's alphas),
    ``err_rows`` (validation rows by which a recorded global error lies
    outside what the margins allow), ``count_miss`` (counters, stamps,
    buffers, margins a round leaves alone and fold rows that differ,
    schedules and intervals that differ, and stumps that name no cell of
    the grid), ``nonfinite`` (NaN or infinite values in the recorded
    states) and ``err_vs_chance``: the federation's last global error over
    the error of always answering the validation set's commoner label."""
    fed = Fed(inputs, settings, F32, device)
    out = dict(pick_gap=0.0, d_gap=0.0, alpha_gap=0.0, margin_gap=0.0,
               err_rows=0, count_miss=0, nonfinite=0)
    states = [{k: (v.to(fed.dev) if torch.is_tensor(v) else v)
               for k, v in s.items()} for s in record["states"]]

    def miss(n):
        out["count_miss"] += int(n)

    def top(k, v):
        out[k] = max(out[k], v)

    def compare(got: Dict, want: Dict) -> None:
        top("d_gap", _d_gap(got["D"], want["D"]))
        for k in ("buf_params", "buf_stamp", "buf_count"):
            miss(_bits_differ(got[k], want[k]))
        for k in ("counter", "last_sync", "sync_count", "ens_count"):
            miss(got[k] != want[k])
        miss(float(got["interval"]) != float(want["interval"]))

    for s in states:
        out["nonfinite"] += _nonfinite(s)
    pos = float((fed.yv > 0).to(F64).mean())
    out["err_vs_chance"] = float(states[-1]["prev_err"]) / max(
        min(pos, 1.0 - pos), 1.0 / fed.yv.numel())
    start = fed.init()
    compare(states[0], start)
    miss(_bits_differ(states[0]["val_margin"], start["val_margin"]))
    blocks: List[torch.Tensor] = []
    alphas: List[torch.Tensor] = []
    for prev, got in zip(states, states[1:]):
        synced = got["sync_count"] != prev["sync_count"]
        slot = (prev["counter"] - prev["last_sync"]) % fed.cap
        if synced:
            # the sync emptied the buffers: the round's stumps are in the
            # rows it folded, client-major
            n_buf = min(prev["counter"] + 1 - prev["last_sync"], fed.cap)
            blk = got.get("block", torch.zeros(0, 4)).to(fed.dev, F32)
            params = (blk.reshape(fed.K, n_buf, 4)[:, slot]
                      if blk.shape[0] == fed.K * n_buf else
                      torch.full((fed.K, 4), math.nan, device=fed.dev))
        else:
            params = got["buf_params"][:, slot].to(F32)
        f, t, pol, bad = _parse(params, fed.thr32)
        miss(bad.sum())
        want = fed.step(prev, {"f": f, "t": t, "pol": pol,
                               "params": params})
        least, ok = want["least"], ~bad
        if bool(ok.any()):
            top("pick_gap", _gap((want["eps"] - least)[ok], 0.0 * least[ok]))
            top("pick_gap", _gap(params[ok, 3], want["eps"][ok]))
        if bool(bad.any()):
            top("pick_gap", math.inf)
        W = want["state"]
        if ("block" in want) != synced:
            miss(1)
            top("d_gap", math.inf)
            break
        if synced:
            got_wrong = round(float(got["prev_err"]) * fed.K * fed.nv)
            vm = want["vm"]
            sure = vm.abs() > MARGIN_BAND * (1.0 + want["vm_l1"])
            lo = int(((torch.where(vm > 0, 1.0, -1.0) != fed.yv) & sure)
                     .sum())
            hi = lo + int((~sure).sum())
            out["err_rows"] += max(0, lo - got_wrong, got_wrong - hi)
            # go on with the recorded error: eq. (1) from the state before
            W["prev_err"] = float(got["prev_err"])
            W["interval"] = next_interval(prev["interval"], W["prev_err"],
                                          prev["prev_err"], fed.sch)
            top("alpha_gap", _gap(got.get("alpha", torch.zeros(0))
                                  .to(fed.dev), want["alpha"]))
            miss(_bits_differ(blk, want["block"]))
            top("margin_gap", _gap(got["val_margin"], W["val_margin"])
                / (1.0 + want["vm_l1"]))
            blocks.append(want["block"])
            alphas.append(want["alpha"])
        else:
            miss(_bits_differ(got["val_margin"], prev["val_margin"]))
        compare(got, W)
    # the whole ensemble: every fold's rows in order, then zeros
    ens_p = torch.as_tensor(record["ens_params"]).to(fed.dev, F32)
    ens_a = torch.as_tensor(record["ens_alpha"]).to(fed.dev, F32)
    n = sum(b.shape[0] for b in blocks)
    if n > ens_p.shape[0]:
        miss(1)
    else:
        miss(_bits_differ(ens_p[:n], torch.cat(blocks) if blocks
                          else ens_p[:0]))
        miss(bool((ens_p[n:] != 0).any()) or bool((ens_a[n:] != 0).any()))
        if alphas:
            top("alpha_gap", _gap(ens_a[:n], torch.cat(alphas)))
    return out


def control(inputs, settings: Dict, n_rounds: int, dtype=torch.bfloat16,
            device="cpu") -> Dict:
    """The federation run on its own in ``dtype``, in the program's place,
    recorded as the program's run is, for ``judge``."""
    fed = Fed(inputs, settings, dtype, device)
    S = fed.init()
    states, blocks, alphas = [S], [], []
    for _ in range(n_rounds):
        res = fed.step(S)
        S = res["state"]
        rec = dict(S)
        if "block" in res:
            rec.update(block=res["block"], alpha=res["alpha"])
            blocks.append(res["block"])
            alphas.append(res["alpha"])
        states.append(rec)
    rows = fed.K * n_rounds
    ens_p = torch.zeros((rows, 4), dtype=F32, device=fed.dev)
    ens_a = torch.zeros((rows,), dtype=F32, device=fed.dev)
    if blocks:
        b, a = torch.cat(blocks).to(F32), torch.cat(alphas).to(F32)
        ens_p[:b.shape[0]], ens_a[:a.shape[0]] = b, a
    to32 = lambda v: (v.to(F32) if torch.is_tensor(v)
                      and v.is_floating_point() else v)
    return {"states": [{k: to32(v) for k, v in s.items()} for s in states],
            "ens_params": ens_p, "ens_alpha": ens_a}
