"""Non-IID client partitioners for federated experiments."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def dirichlet_partition(x: np.ndarray, y: np.ndarray, n_clients: int,
                        alpha: float, rng: np.random.RandomState
                        ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Label-skew partition: for each class, client shares ~ Dir(alpha).
    Lower alpha -> more skew.  Every client gets >= 8 samples (top-up from a
    shuffled pool so stumps always have something to fit)."""
    classes = np.unique(y)
    client_idx: List[List[int]] = [[] for _ in range(n_clients)]
    for c in classes:
        idx = np.where(y == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for cid, part in enumerate(np.split(idx, cuts)):
            client_idx[cid].extend(part.tolist())
    # top up only with indices the client does not already hold — a client
    # must never see the same sample twice (it would double that sample's
    # boosting-distribution mass); cross-client overlap from topping up is
    # fine and unavoidable.  The floor is min(8, n): with fewer than 8
    # distinct samples in the whole dataset 8 distinct ones don't exist.
    floor = min(8, len(y))
    pool = rng.permutation(len(y)).tolist()
    for cid in range(n_clients):
        have = set(client_idx[cid])
        while len(client_idx[cid]) < floor:
            if not pool:
                pool = rng.permutation(len(y)).tolist()
            cand = pool.pop()
            if cand in have:
                continue
            client_idx[cid].append(cand)
            have.add(cand)
    out = []
    for cid in range(n_clients):
        sel = np.asarray(client_idx[cid])
        out.append((x[sel], y[sel]))
    return out


def label_shard_partition(x: np.ndarray, y: np.ndarray, n_clients: int,
                          shards_per_client: int,
                          rng: np.random.RandomState
                          ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """McMahan-style pathological split: sort by label, deal out shards."""
    order = np.argsort(y, kind="stable")
    shards = np.array_split(order, n_clients * shards_per_client)
    rng.shuffle(shards)
    out = []
    for cid in range(n_clients):
        sel = np.concatenate(shards[cid * shards_per_client:
                                    (cid + 1) * shards_per_client])
        out.append((x[sel], y[sel]))
    return out


def iid_partition(x: np.ndarray, y: np.ndarray, n_clients: int,
                  rng: np.random.RandomState
                  ) -> List[Tuple[np.ndarray, np.ndarray]]:
    idx = rng.permutation(len(y))
    out = []
    for part in np.array_split(idx, n_clients):
        out.append((x[part], y[part]))
    return out
