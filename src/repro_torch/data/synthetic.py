"""Synthetic dataset generators for the paper's five application domains.

The paper publishes no datasets; each generator below produces a binary
classification problem whose statistical character matches the published
description of its domain (feature count, class balance, noise level,
non-IID client skew).  All generators are deterministic given a seed.

Labels are in {-1,+1}.  Features are float32 (N,F).
"""
from __future__ import annotations

import zlib
from typing import Dict, Tuple

import numpy as np

from repro_torch.configs.paper_fedboost import DomainConfig
from repro_torch.data.partition import (
    dirichlet_partition, iid_partition, label_shard_partition)


def _base_problem(rng: np.random.RandomState, n: int, f: int,
                  pos_frac: float, noise: float,
                  n_clusters: int = 6) -> Tuple[np.ndarray, np.ndarray]:
    """Cluster-structured binary problem: each cluster has a class bias;
    decision surface is non-linear (union of clusters), which stumps can
    only fit as an ensemble — the regime AdaBoost is designed for."""
    centers = rng.randn(n_clusters, f) * 2.0
    cluster_label = np.where(
        rng.rand(n_clusters) < pos_frac, 1.0, -1.0)
    # guarantee both classes exist
    cluster_label[0], cluster_label[1] = 1.0, -1.0
    assign = rng.randint(0, n_clusters, size=n)
    x = centers[assign] + rng.randn(n, f)
    y = cluster_label[assign].copy()
    flip = rng.rand(n) < noise
    y[flip] *= -1.0
    return x.astype(np.float32), y.astype(np.float32)


def make_domain_data(cfg: DomainConfig, seed: int = 0,
                     val_frac: float = 0.15, test_frac: float = 0.15,
                     partitioner: str = "dirichlet",
                     shards_per_client: int = 2,
                     as_numpy: bool = True) -> Dict:
    """Returns {"clients": [(x,y)...], "val": (x,y), "test": (x,y)}.

    ``partitioner`` selects the client split (scenario registry binding):
    ``dirichlet`` (default, skew from ``cfg.noniid_alpha``), ``iid``, or
    ``label_shard`` (McMahan-style pathological split with
    ``shards_per_client`` shards per client).

    Every array is a contiguous numpy array; the engine moves the client
    shards and the val/test sets onto its own device.  ``as_numpy`` is
    accepted so that a scenario's data kwargs pass through unchanged: the
    arrays are numpy whatever it says."""
    # stable across processes (python's hash() is salted per-interpreter)
    name_tag = zlib.crc32(cfg.name.encode()) % 997
    rng = np.random.RandomState(seed * 1000 + name_tag)
    x, y = _base_problem(rng, cfg.n_samples, cfg.n_features,
                         cfg.label_imbalance, cfg.noise)

    # domain flavour adjustments
    if cfg.name == "iot":
        # sensor drift: add a per-feature slow bias (distribution shift)
        x += np.linspace(0, 0.5, cfg.n_features)[None, :]
    if cfg.name == "healthcare":
        # rare positives with higher-dimensional signal overlap
        pos = y > 0
        x[pos] += rng.randn(int(pos.sum()), cfg.n_features) * 0.3
    if cfg.name == "mobile":
        # sparse activations (next-word-ish features)
        mask = rng.rand(*x.shape) < 0.5
        x = np.where(mask, x, 0.0).astype(np.float32)

    n = x.shape[0]
    idx = rng.permutation(n)
    n_val, n_test = int(n * val_frac), int(n * test_frac)
    val_idx, test_idx, train_idx = (
        idx[:n_val], idx[n_val:n_val + n_test], idx[n_val + n_test:])

    if partitioner == "dirichlet":
        clients = dirichlet_partition(
            x[train_idx], y[train_idx], cfg.n_clients, cfg.noniid_alpha, rng)
    elif partitioner == "iid":
        clients = iid_partition(x[train_idx], y[train_idx],
                                cfg.n_clients, rng)
    elif partitioner == "label_shard":
        clients = label_shard_partition(x[train_idx], y[train_idx],
                                        cfg.n_clients, shards_per_client, rng)
    else:
        raise ValueError(f"unknown partitioner {partitioner!r}; choose "
                         "from dirichlet | iid | label_shard")
    to_a = lambda a, b: (np.ascontiguousarray(a), np.ascontiguousarray(b))
    return {
        "clients": [to_a(cx, cy) for cx, cy in clients],
        "val": to_a(x[val_idx], y[val_idx]),
        "test": to_a(x[test_idx], y[test_idx]),
    }
