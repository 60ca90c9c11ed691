"""Gradient-averaging FL baselines the paper positions itself against:
FedAvg (McMahan et al., 2017) and FedAsync (Xie et al., 2019).

These train a shared neural model (a tiny MLP) instead of a boosted
ensemble, on the same domain datasets and under the same cost model as
the boosting engine, so a comparison sets accuracy against bytes on the
wire: *learner* traffic is far cheaper than *weight* traffic.

The model and its gradient steps run on an explicit device (the card by
default; asking for it without one raises), from an init drawn from a
``torch.Generator`` seeded with ``seed``.  The clients' speeds come from
``np.random.RandomState(seed)`` as in the JAX package, so bytes, messages
and the simulated clock equal its own whatever the model learns.
``torch.Generator`` does not give ``jax.random``'s bits, so a parity test
hands both packages the same init through :func:`mlp_init`.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.models.weak import gradient_steps

F32 = torch.float32
Params = Dict[str, torch.Tensor]


def mlp_init(generator: torch.Generator, n_features: int, hidden: int = 32
             ) -> Params:
    """Normal weights scaled by 1/sqrt(fan-in) and zero biases, on the
    generator's device."""
    dev = generator.device
    return {
        "w1": torch.randn((n_features, hidden), generator=generator,
                          device=dev) / math.sqrt(n_features),
        "b1": torch.zeros((hidden,), dtype=F32, device=dev),
        "w2": torch.randn((hidden, 1), generator=generator,
                          device=dev) / math.sqrt(hidden),
        "b2": torch.zeros((1,), dtype=F32, device=dev),
    }


def mlp_forward(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = torch.tanh(x @ p["w1"] + p["b1"])
    return (h @ p["w2"] + p["b2"])[:, 0]


def bce_loss(p: Params, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Mean logistic loss of labels y in {-1,+1}, in the stable form."""
    logits = mlp_forward(p, x)
    y01 = (y + 1.0) / 2.0
    return torch.mean(torch.maximum(logits, torch.zeros_like(logits))
                      - logits * y01
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def local_sgd(params: Params, x: torch.Tensor, y: torch.Tensor,
              lr: float = 0.1, steps: int = 10) -> Params:
    """``steps`` full-batch gradient steps on :func:`bce_loss`."""
    return gradient_steps(lambda p: bce_loss(p, x, y), params, steps, lr)


def params_bytes(p: Params) -> int:
    return int(sum(v.numel() * v.element_size() for v in p.values()))


@dataclass
class FedAvgMetrics:
    mode: str
    sim_time_s: float = 0.0
    uplink_bytes: int = 0
    downlink_bytes: int = 0
    n_messages: int = 0
    final_test_error: float = 1.0
    error_curve: List[Tuple[float, float]] = field(default_factory=list)

    @property
    def total_bytes(self) -> int:
        return self.uplink_bytes + self.downlink_bytes


def _on_device(data: Dict, dev: torch.device):
    def move(a):
        return torch.tensor(np.asarray(a), dtype=F32).to(dev)
    clients = [(move(x), move(y)) for x, y in data["clients"]]
    return clients, tuple(move(a) for a in data["test"])


def _test_error(params: Params, xt: torch.Tensor, yt: torch.Tensor) -> float:
    return float(torch.mean(
        (torch.sign(mlp_forward(params, xt)) != yt).to(F32)))


def run_fedavg(data: Dict, n_rounds: int = 30, lr: float = 0.1,
               local_steps: int = 10, seed: int = 0,
               straggler_factor: float = 4.0, link_mbps: float = 10.0,
               header_bytes: int = 256, device="cuda") -> FedAvgMetrics:
    """Synchronous FedAvg with the same cost model as the boosting engine."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    clients, (xt, yt) = _on_device(data, dev)
    K = len(clients)
    speeds = np.exp(rng.uniform(0, math.log(straggler_factor), size=K))
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = mlp_init(gen, clients[0][0].shape[1])
    pbytes = params_bytes(params)
    m = FedAvgMetrics(mode="fedavg")
    t = 0.0
    for r in range(n_rounds):
        rsp = obs.span("train.round", sim_t=t, round=r, mode="fedavg")
        locs, durs = [], []
        for k, (x, y) in enumerate(clients):
            locs.append(local_sgd(params, x, y, lr, local_steps))
            tx = (pbytes + header_bytes) / (link_mbps / 8 * 1e6) + 0.05
            durs.append(1.0 * speeds[k] + tx)
            m.uplink_bytes += pbytes + header_bytes
            m.n_messages += 1
        t += max(durs)
        params = {k: sum(loc[k] for loc in locs) / K for k in params}
        m.downlink_bytes += K * (pbytes + header_bytes)
        m.n_messages += K
        err = _test_error(params, xt, yt)
        m.error_curve.append((t, err))
        rsp.set(val_error=err)
        rsp.end(sim_t=t)
    m.sim_time_s = t
    m.final_test_error = m.error_curve[-1][1]
    return m


def run_fedasync(data: Dict, n_rounds: int = 30, lr: float = 0.1,
                 local_steps: int = 10, seed: int = 0, mix: float = 0.5,
                 staleness_decay: float = 0.3,
                 straggler_factor: float = 4.0, link_mbps: float = 10.0,
                 header_bytes: int = 256, device="cuda") -> FedAvgMetrics:
    """FedAsync (Xie et al., 2019): server mixes each arriving update with
    weight mix * s(tau), s polynomial in staleness."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    clients, (xt, yt) = _on_device(data, dev)
    K = len(clients)
    speeds = np.exp(rng.uniform(0, math.log(straggler_factor), size=K))
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = mlp_init(gen, clients[0][0].shape[1])
    pbytes = params_bytes(params)
    m = FedAvgMetrics(mode="fedasync")

    server_version = 0
    events = []   # (arrival, client, version_at_start, local_params)

    def schedule(k: int, t0: float):
        x, y = clients[k]
        loc = local_sgd(params, x, y, lr, local_steps)
        tx = (pbytes + header_bytes) / (link_mbps / 8 * 1e6) + 0.05
        heapq.heappush(events, (t0 + speeds[k] + tx, k, server_version, loc))
        m.uplink_bytes += pbytes + header_bytes
        m.n_messages += 1

    for k in range(K):
        schedule(k, 0.0)
    merges, t = 0, 0.0
    while events and merges < n_rounds * K:
        t, k, v0, loc = heapq.heappop(events)
        tau = server_version - v0
        w = mix * (1.0 + tau) ** (-staleness_decay)
        params = {n: (1 - w) * params[n] + w * loc[n] for n in params}
        server_version += 1
        merges += 1
        if obs.enabled():
            obs.point("train.sync", sim_t0=t, sim_t1=t, cid=int(k),
                      staleness=int(tau), mode="fedasync")
        m.downlink_bytes += pbytes + header_bytes
        m.n_messages += 1
        if merges % K == 0:
            m.error_curve.append((t, _test_error(params, xt, yt)))
        schedule(k, t)
    m.sim_time_s = t
    m.final_test_error = (m.error_curve[-1][1] if m.error_curve else 1.0)
    return m
