"""Carry learners, snapshots, clusters, data and LM params across from
numpy.

Both packages compute on the same inputs when each is handed the same
numpy arrays: the JAX package's learners, snapshots, a cluster's registry
windows, domain data and LM params turn into numpy with ``np.asarray``
(``jax.tree.map`` for a params pytree), and these functions turn numpy
into this package's equivalents.
Nothing here imports the JAX package.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.serve.registry import EnsembleSnapshot
from repro_torch.serve.shard import GossipConfig, ShardCluster

F32 = torch.float32


def stumps_from_numpy(features: Sequence, thresholds: Sequence,
                      polarities: Sequence, device="cpu") -> List[Dict]:
    """Stump param dicts (0-d tensors on ``device``) from per-learner
    feature indices, thresholds and polarities."""
    dev = resolve_device(device)
    return [{"feature": torch.tensor(int(f), dtype=torch.int32, device=dev),
             "threshold": torch.tensor(np.float32(t), dtype=F32, device=dev),
             "polarity": torch.tensor(np.float32(p), dtype=F32, device=dev)}
            for f, t, p in zip(features, thresholds, polarities)]


def snapshot_from_numpy(stump_params, alphas, tenant: str, version: int,
                        train_progress: int, published_at: float = 0.0
                        ) -> EnsembleSnapshot:
    """A stump :class:`EnsembleSnapshot` from its packed (T, 4) f32 params
    and (T,) f32 vote weights, with the same content fingerprint as the
    snapshot they came from."""
    sp = torch.from_numpy(np.array(stump_params, np.float32, copy=True))
    al = torch.from_numpy(np.array(alphas, np.float32, copy=True))
    if sp.shape != (al.shape[0], 4):
        raise ValueError(f"stump_params {tuple(sp.shape)} vs alphas "
                         f"{tuple(al.shape)}")
    return EnsembleSnapshot(
        tenant=tenant, version=int(version), published_at=float(published_at),
        train_progress=int(train_progress), weak_name="stump", alphas=al,
        stump_params=sp)


def params_from_numpy(learners: Sequence[Mapping], device="cpu"
                      ) -> List[Dict]:
    """Generic (logistic / mlp) param dicts of tensors on ``device`` from
    dicts of arrays, each leaf with its own dtype and shape (0-d biases
    stay 0-d)."""
    dev = resolve_device(device)
    return [{k: torch.from_numpy(np.array(v, copy=True)).to(dev)
             for k, v in p.items()} for p in learners]


def generic_snapshot_from_numpy(learners: Sequence[Mapping], alphas,
                                weak_name: str, tenant: str, version: int,
                                train_progress: int,
                                published_at: float = 0.0
                                ) -> EnsembleSnapshot:
    """A generic (logistic / mlp) :class:`EnsembleSnapshot` from its
    learners' param dicts of arrays and its (T,) f32 vote weights, with the
    same content fingerprint as the snapshot they came from."""
    al = torch.from_numpy(np.array(alphas, np.float32, copy=True))
    if len(learners) != al.shape[0]:
        raise ValueError(f"{len(learners)} learners vs alphas "
                         f"{tuple(al.shape)}")
    if weak_name == "stump":
        raise ValueError("stump snapshots carry packed params: use "
                         "snapshot_from_numpy")
    return EnsembleSnapshot(
        tenant=tenant, version=int(version), published_at=float(published_at),
        train_progress=int(train_progress), weak_name=weak_name, alphas=al,
        learners=tuple(params_from_numpy(learners)))


def cluster_windows(cluster) -> Dict[str, List[Dict]]:
    """Each host's retained registry windows, oldest first, as the
    mappings :func:`shard_cluster_from_numpy` takes: the snapshots' stamps,
    fingerprints and arrays as numpy.  ``cluster`` is any cluster whose
    hosts' registries have ``tenants()`` and ``history(tenant)`` (this
    package's, or the JAX package's)."""
    def one(s) -> Dict:
        out = dict(tenant=s.tenant, version=s.version,
                   published_at=s.published_at,
                   train_progress=s.train_progress, weak_name=s.weak_name,
                   fingerprint=s.fingerprint, alphas=np.asarray(s.alphas))
        if s.stump_params is not None:
            out["stump_params"] = np.asarray(s.stump_params)
        else:
            out["learners"] = [{k: np.asarray(v) for k, v in p.items()}
                               for p in s.learners]
        return out
    return {hid: [one(s) for t in h.registry.tenants()
                  for s in h.registry.history(t)]
            for hid, h in cluster.hosts.items()}


def shard_cluster_from_numpy(hosts: Mapping[str, Sequence[Mapping]],
                             cfg: Optional[GossipConfig] = None, *,
                             rng_state=None) -> ShardCluster:
    """A :class:`ShardCluster` holding another cluster's state.

    ``hosts`` maps each host id, in the cluster's order, to its retained
    registry window, oldest first (:func:`cluster_windows`): one mapping a
    snapshot with ``tenant``, ``version``, ``published_at``,
    ``train_progress``, ``weak_name``, ``alphas`` and either
    ``stump_params`` (stumps) or ``learners`` (a sequence of param dicts),
    arrays as anything ``np.asarray`` takes, and optionally the
    ``fingerprint`` it had there.  Each window is ingested with its version
    stamps and publish times kept; a snapshot whose content fingerprint
    differs from the one given raises.  ``rng_state``
    (``random.Random.getstate()`` of the source cluster's peer-selection
    RNG) continues its gossip; every host starts up."""
    cluster = ShardCluster(cfg=cfg, host_ids=list(hosts))
    for hid, window in hosts.items():
        registry = cluster.hosts[hid].registry
        for s in window:
            meta = dict(tenant=s["tenant"], version=s["version"],
                        train_progress=s["train_progress"],
                        published_at=s["published_at"])
            if s["weak_name"] == "stump":
                snap = snapshot_from_numpy(np.asarray(s["stump_params"]),
                                           np.asarray(s["alphas"]), **meta)
            else:
                snap = generic_snapshot_from_numpy(
                    s["learners"], np.asarray(s["alphas"]), s["weak_name"],
                    **meta)
            want = s.get("fingerprint")
            if want is not None and snap.fingerprint != want:
                raise ValueError(f"{hid}: {snap.tenant} v{snap.version} "
                                 f"fingerprint {snap.fingerprint} != {want}")
            registry.ingest(snap)
    if rng_state is not None:
        cluster._rng.setstate(rng_state)
    return cluster


def domain_data_from_numpy(clients: Sequence, val, test) -> Dict:
    """The engine's data dict ``{"clients": [(x, y)...], "val": (x, y),
    "test": (x, y)}`` as f32 numpy arrays, from anything ``np.asarray``
    takes (the engine moves them to its device)."""
    def pair(x, y):
        return (np.ascontiguousarray(np.asarray(x, np.float32)),
                np.ascontiguousarray(np.asarray(y, np.float32)))
    return {"clients": [pair(x, y) for x, y in clients],
            "val": pair(*val), "test": pair(*test)}


def lm_params_from_numpy(params: Mapping, cfg: ArchConfig, device="cpu"):
    """The port's :class:`~repro_torch.models.transformer.Transformer` from
    the JAX package's LM params pytree as numpy: ``embed``,
    ``final_norm``, ``lm_head`` where untied, and ``blocks``, one dict per
    pattern slot whose leaves carry a leading ``n_periods`` axis.  Layer i
    takes period ``i // p`` of slot ``i % p``."""
    from repro_torch.models.transformer import Transformer
    dev = resolve_device(device)
    model = Transformer(cfg, gen=None, device=dev)
    p = cfg.pattern_period

    def put(dst: torch.Tensor, src) -> None:
        src = np.asarray(src)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"param of shape {src.shape} for "
                             f"{tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(np.array(src, copy=True)))

    with torch.no_grad():
        put(model.embed, params["embed"])
        put(model.final_norm, params["final_norm"])
        if model.lm_head is not None:
            put(model.lm_head, params["lm_head"])
        for i, block in enumerate(model.blocks):
            src = params["blocks"][i % p]
            put(block.norm1, src["norm1"][i // p])
            for name, t in block.attn.named_parameters():
                put(t, src["attn"][name][i // p])
            put(block.norm2, src["norm2"][i // p])
            for name, t in block.mlp.items():
                put(t, src["mlp"][name][i // p])
    return model
