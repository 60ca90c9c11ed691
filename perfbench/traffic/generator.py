"""The benchmark's frozen copy of the domain data generator.

``make_domain_data`` and the partitioners are copied from
``repro_torch/data/synthetic.py`` and ``repro_torch/data/partition.py`` as
they stood when the benchmark was written, so a later change to the program
cannot change the yardstick's data; a CPU test holds the two to the same
arrays.  ``mesh_inputs`` stacks a deployment the way the mesh step takes it:
every client shard cut to the smallest one, (K, n_local, F) and (K, n_local),
and the validation set cut into K slices of ``len(val) // K`` rows.

The dataset is fixed by the configuration's ``data_seed``.  The run's seed
permutes the rows inside each client's shard and inside each validation
slice: every computation of the mesh step is per row or an order-free sum
over one client's rows, so every seed does the same work on the same data,
laid out in another order.
"""
from __future__ import annotations

import zlib
from typing import Dict, List, Tuple

import numpy as np

Arrays = Tuple[np.ndarray, np.ndarray]


def _base_problem(rng: np.random.RandomState, n: int, f: int,
                  pos_frac: float, noise: float,
                  n_clusters: int = 6) -> Arrays:
    centers = rng.randn(n_clusters, f) * 2.0
    cluster_label = np.where(rng.rand(n_clusters) < pos_frac, 1.0, -1.0)
    cluster_label[0], cluster_label[1] = 1.0, -1.0
    assign = rng.randint(0, n_clusters, size=n)
    x = centers[assign] + rng.randn(n, f)
    y = cluster_label[assign].copy()
    flip = rng.rand(n) < noise
    y[flip] *= -1.0
    return x.astype(np.float32), y.astype(np.float32)


def dirichlet_partition(x, y, n_clients: int, alpha: float,
                        rng: np.random.RandomState) -> List[Arrays]:
    classes = np.unique(y)
    client_idx: List[List[int]] = [[] for _ in range(n_clients)]
    for c in classes:
        idx = np.where(y == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * n_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for cid, part in enumerate(np.split(idx, cuts)):
            client_idx[cid].extend(part.tolist())
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


def label_shard_partition(x, y, n_clients: int, shards_per_client: int,
                          rng: np.random.RandomState) -> List[Arrays]:
    order = np.argsort(y, kind="stable")
    shards = np.array_split(order, n_clients * shards_per_client)
    rng.shuffle(shards)
    out = []
    for cid in range(n_clients):
        sel = np.concatenate(shards[cid * shards_per_client:
                                    (cid + 1) * shards_per_client])
        out.append((x[sel], y[sel]))
    return out


def iid_partition(x, y, n_clients: int,
                  rng: np.random.RandomState) -> List[Arrays]:
    idx = rng.permutation(len(y))
    return [(x[part], y[part]) for part in np.array_split(idx, n_clients)]


def make_domain_data(dom: Dict, seed: int = 0, val_frac: float = 0.15,
                     test_frac: float = 0.15, partitioner: str = "dirichlet",
                     shards_per_client: int = 2) -> Dict:
    """{"clients": [(x, y)...], "val": (x, y), "test": (x, y)} of one
    domain (``dom`` holds ``name``, ``n_samples``, ``n_features``,
    ``n_clients``, ``noniid_alpha``, ``label_imbalance`` and ``noise``);
    labels in {-1, +1}, features f32."""
    name_tag = zlib.crc32(dom["name"].encode()) % 997
    rng = np.random.RandomState(seed * 1000 + name_tag)
    x, y = _base_problem(rng, dom["n_samples"], dom["n_features"],
                         dom["label_imbalance"], dom["noise"])
    if dom["name"] == "iot":
        x += np.linspace(0, 0.5, dom["n_features"])[None, :]
    if dom["name"] == "healthcare":
        pos = y > 0
        x[pos] += rng.randn(int(pos.sum()), dom["n_features"]) * 0.3
    if dom["name"] == "mobile":
        mask = rng.rand(*x.shape) < 0.5
        x = np.where(mask, x, 0.0).astype(np.float32)
    n = x.shape[0]
    idx = rng.permutation(n)
    n_val, n_test = int(n * val_frac), int(n * test_frac)
    val_idx, test_idx, train_idx = (
        idx[:n_val], idx[n_val:n_val + n_test], idx[n_val + n_test:])
    K = dom["n_clients"]
    if partitioner == "dirichlet":
        clients = dirichlet_partition(x[train_idx], y[train_idx], K,
                                      dom["noniid_alpha"], rng)
    elif partitioner == "iid":
        clients = iid_partition(x[train_idx], y[train_idx], K, rng)
    elif partitioner == "label_shard":
        clients = label_shard_partition(x[train_idx], y[train_idx], K,
                                        shards_per_client, rng)
    else:
        raise ValueError(f"unknown partitioner {partitioner!r}")
    to_a = lambda a, b: (np.ascontiguousarray(a), np.ascontiguousarray(b))
    return {"clients": [to_a(cx, cy) for cx, cy in clients],
            "val": to_a(x[val_idx], y[val_idx]),
            "test": to_a(x[test_idx], y[test_idx])}


def stack_mesh(data: Dict, K: int) -> Tuple[np.ndarray, ...]:
    """(x (K,n,F), y (K,n), xv (K,nv,F), yv (K,nv)): every shard cut to the
    smallest one's n rows, the validation set cut into K slices of
    nv = len(val) // K rows (the rest left out)."""
    n = min(c[0].shape[0] for c in data["clients"])
    x = np.stack([c[0][:n] for c in data["clients"]])
    y = np.stack([c[1][:n] for c in data["clients"]])
    xv, yv = data["val"]
    nv = xv.shape[0] // K
    if n == 0 or nv == 0:
        raise ValueError(f"{K} clients: {n} rows a shard, {nv} validation "
                         "rows a client")
    return x, y, xv[:K * nv].reshape(K, nv, -1), yv[:K * nv].reshape(K, nv)


def permute_rows(arrays, seed: int) -> Tuple[np.ndarray, ...]:
    """The run's layout: the rows of each client's shard and of each
    client's validation slice in an order drawn from ``seed``."""
    x, y, xv, yv = arrays
    rng = np.random.default_rng(seed)
    out = []
    for a, b in ((x, y), (xv, yv)):
        K, n = b.shape
        perm = rng.permuted(np.tile(np.arange(n), (K, 1)), axis=1)
        out += [np.ascontiguousarray(np.take_along_axis(a, perm[:, :, None],
                                                        axis=1)),
                np.ascontiguousarray(np.take_along_axis(b, perm, axis=1))]
    return tuple(out)


def mesh_inputs(config: Dict, seed: int) -> Tuple[np.ndarray, ...]:
    """The cell's (x, y, xv, yv) for the run's ``seed``, from the
    configuration's domain, partitioner, split and ``data_seed``, at the
    rows a client that the configuration states."""
    dom = {k: config[k] for k in ("n_samples", "n_features", "n_clients",
                                  "noniid_alpha", "label_imbalance",
                                  "noise")}
    dom["name"] = config["domain"]
    data = make_domain_data(dom, seed=config["data_seed"],
                            val_frac=config["val_frac"],
                            test_frac=config["test_frac"],
                            partitioner=config["partitioner"])
    stacked = stack_mesh(data, config["n_clients"])
    shape = (stacked[0].shape[1], stacked[2].shape[1])
    want = (config["rows_per_client"], config["val_rows_per_client"])
    if shape != want:
        raise ValueError(f"{shape} training and validation rows a client, "
                         f"the configuration states {want}")
    return permute_rows(stacked, seed)


def thresholds(x: np.ndarray, n_thresholds: int) -> np.ndarray:
    """The (F, T) threshold grid every client shares: the interior
    quantiles i / (T + 1), i = 1..T, of each feature over every client's
    rows, interpolated linearly between order statistics in f64 and
    rounded once to f32."""
    flat = np.sort(x.reshape(-1, x.shape[-1]).astype(np.float64), axis=0)
    n = flat.shape[0]
    q = np.arange(1, n_thresholds + 1, dtype=np.float64) / (n_thresholds + 1)
    pos = q * (n - 1)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, n - 1)
    w = (pos - lo)[:, None]
    grid = flat[lo] * (1.0 - w) + flat[hi] * w
    return np.ascontiguousarray(grid.T.astype(np.float32))
