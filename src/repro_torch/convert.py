"""Carry learners, snapshots, clusters, chains, data and LM params across
from numpy.

Both packages compute on the same inputs when each is handed the same
numpy arrays: the JAX package's learners, snapshots, a cluster's registry
windows, a chain cluster's state, domain data, a mesh trainer's state and
LM params turn into
numpy with ``np.asarray`` (``jax.tree.map`` for a params pytree;
:func:`cluster_windows` and :func:`chain_to_numpy` for a cluster), and
these functions turn numpy into this package's equivalents.
Nothing here imports the JAX package.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch

from repro_torch.chain import Block, Chain, ChainCluster, ChainCommit
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.serve.registry import EnsembleSnapshot
from repro_torch.serve.shard import GossipConfig, GossipStats, ShardCluster
from repro_torch.sim.behavior import BlockchainLedger

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


def _commit_to_numpy(c) -> Dict:
    return dict(tenant=c.tenant, cid=int(c.cid), seq=int(c.seq),
                rounds=[int(r) for r in c.rounds],
                alphas=[float(a) for a in c.alphas],
                stump_rows=(None if c.stump_rows is None
                            else np.asarray(c.stump_rows, np.float32)),
                learners=[{k: np.asarray(v) for k, v in p.items()}
                          for p in c.learners],
                weak_name=c.weak_name, train_progress=int(c.train_progress),
                submitted_at=float(c.submitted_at),
                fingerprint=c.fingerprint)


def _node_to_numpy(reg) -> Dict:
    return dict(next_height=int(reg._next_height),
                submitted=dict(reg._submitted))


def chain_to_numpy(cluster) -> Dict:
    """A chain cluster's whole state as numpy and plain Python, as
    :func:`chain_from_numpy` takes it: the blocks with their commits and
    hashes, the pending queue in its heap order, the chain's and the
    ledger's RNG states and counters, the ledger's reserved slots and
    cursors, the committee's participants in join order, each host's
    liveness and fold height, the committer's, the gossip stats and RNG,
    and the clock epoch.  ``cluster`` is a chain cluster of this package
    or of the JAX package; observability contexts are not carried."""
    ch, led = cluster.chain, cluster.chain.ledger
    return dict(
        blocks=[dict(height=b.height, prev_hash=b.prev_hash,
                     mined_at=float(b.mined_at), miner=b.miner, hash=b.hash,
                     commits=[_commit_to_numpy(c) for c in b.commits])
                for b in ch.blocks],
        pending=[(float(due), int(seq), _commit_to_numpy(c))
                 for due, seq, c in ch._pending],
        seq=ch._seq, finalized=ch._finalized, reorgs=ch.reorgs,
        participants=ch.participants(), confirmations=ch.confirmations,
        reorg_prob=ch.reorg_prob, committee_size=ch.committee_size,
        epoch_blocks=ch.epoch_blocks, rng_state=ch._rng.get_state(),
        cursor_id=getattr(ch, "_cursor_id", None),
        ledger=dict(rng_state=led.rng.get_state(),
                    block_interval_s=led.block_interval_s, gap=led.gap,
                    prune_every=led.prune_every, slots=list(led._slots),
                    cursors=list(led._cursors), untracked=led._untracked,
                    since_prune=led._since_prune,
                    pruned_slots=led.pruned_slots),
        hosts={hid: dict(up=h.up, **_node_to_numpy(h.registry))
               for hid, h in cluster.hosts.items()},
        committer=_node_to_numpy(cluster._committer),
        stats=dict(vars(cluster.stats)), gossip_rng=cluster._rng.getstate(),
        clock_epoch=cluster._clock_epoch)


def _commit_from_numpy(c: Mapping) -> ChainCommit:
    rows = c["stump_rows"]
    commit = ChainCommit(
        tenant=c["tenant"], cid=int(c["cid"]), seq=int(c["seq"]),
        rounds=tuple(int(r) for r in c["rounds"]),
        alphas=tuple(float(a) for a in c["alphas"]),
        stump_rows=(None if rows is None else
                    tuple(map(tuple, np.asarray(rows, np.float32)))),
        learners=tuple(params_from_numpy(c["learners"])),
        weak_name=c["weak_name"], train_progress=int(c["train_progress"]),
        submitted_at=float(c["submitted_at"]))
    want = c.get("fingerprint")
    if want is not None and commit.fingerprint != want:
        raise ValueError(f"commit seq {commit.seq}: fingerprint "
                         f"{commit.fingerprint} != {want}")
    return commit


def _fold_to(reg, blocks: Sequence[Block], node: Mapping) -> None:
    """Fold ``blocks[1:next_height]`` into a fresh chain registry: its view
    is a pure function of the confirmed prefix it has folded."""
    for b in blocks[1:int(node["next_height"])]:
        reg._fold_block(b)
    reg._next_height = int(node["next_height"])
    reg._submitted = dict(node["submitted"])


def chain_from_numpy(state: Mapping, cfg: Optional[GossipConfig] = None
                     ) -> ChainCluster:
    """A :class:`~repro_torch.chain.ChainCluster` holding another chain
    cluster's state (:func:`chain_to_numpy`), so that both go on from the
    same chain: the same block hashes, confirmation draws, reorgs and
    committee.  Every commit's fingerprint and every block's hash is
    computed afresh and must equal the one recorded, else this raises.
    Each node's view is rebuilt by folding the confirmed blocks below its
    fold height, then rebased to the clock epoch when one was set."""
    led = state["ledger"]
    ledger = BlockchainLedger(np.random.RandomState(),
                              block_interval_s=led["block_interval_s"],
                              prune_every=led["prune_every"])
    ledger.rng.set_state(led["rng_state"])
    ledger.gap = float(led["gap"])
    ledger._slots = [float(t) for t in led["slots"]]
    ledger._cursors = [float(t) for t in led["cursors"]]
    ledger._untracked = bool(led["untracked"])
    ledger._since_prune = int(led["since_prune"])
    ledger.pruned_slots = int(led["pruned_slots"])
    chain = Chain(ledger, confirmations=state["confirmations"],
                  reorg_prob=state["reorg_prob"],
                  committee_size=state["committee_size"],
                  epoch_blocks=state["epoch_blocks"])
    chain._rng.set_state(state["rng_state"])
    chain.blocks = []
    for b in state["blocks"]:
        block = Block(int(b["height"]), b["prev_hash"], float(b["mined_at"]),
                      tuple(_commit_from_numpy(c) for c in b["commits"]),
                      miner=b["miner"])
        if block.hash != b["hash"]:
            raise ValueError(f"block {block.height}: hash {block.hash} != "
                             f"{b['hash']}")
        chain.blocks.append(block)
    chain._pending = [(float(due), int(seq), _commit_from_numpy(c))
                      for due, seq, c in state["pending"]]
    chain._seq = int(state["seq"])
    chain._finalized = bool(state["finalized"])
    chain.reorgs = int(state["reorgs"])
    if state["cursor_id"] is not None:
        chain._cursor_id = int(state["cursor_id"])

    cluster = ChainCluster(cfg=cfg, host_ids=list(state["hosts"]),
                           chain=chain)
    # the hosts joined while the cluster was built: restore the recorded
    # committee (killed hosts left it) in its join order
    chain._participants = dict.fromkeys(state["participants"])
    for hid, node in state["hosts"].items():
        _fold_to(cluster.hosts[hid].registry, chain.blocks, node)
        cluster.hosts[hid].up = bool(node["up"])
    _fold_to(cluster._committer, chain.blocks, state["committer"])
    cluster.stats = GossipStats(**state["stats"])
    cluster._rng.setstate(state["gossip_rng"])
    if state["clock_epoch"] is not None:
        cluster._clock_epoch = float(state["clock_epoch"])
        for h in cluster.hosts.values():
            h.registry.rebase_clock(cluster._clock_epoch)
        cluster._committer.rebase_clock(cluster._clock_epoch)
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


LAYER_STACKS = ("enc_layers", "dec_layers")


def _lm_path(name: str, p: int):
    """A port LM param's name -> (its path in the JAX package's params
    pytree, its index on the leaf's leading axis).  In a decoder stack
    layer i is period ``i // p`` of slot ``i % p`` of ``blocks``; in an
    encoder-decoder stack layer i is entry i of ``enc_layers`` or
    ``dec_layers``, stacked per layer; a param outside the layers has no
    index."""
    parts = name.split(".")
    if parts[0] in LAYER_STACKS:
        return (parts[0],) + tuple(parts[2:]), int(parts[1])
    if parts[0] != "blocks":
        return tuple(parts), None
    i = int(parts[1])
    return ("blocks", i % p) + tuple(parts[2:]), i // p


def lm_leaf(tree: Mapping, name: str, cfg: ArchConfig):
    """The value for the port's LM param ``name`` in the JAX package's
    stacked params pytree (one period of its slot's stacked leaf, or one
    layer of an encoder-decoder stack's)."""
    path, index = _lm_path(name, cfg.pattern_period)
    for key in path:
        tree = tree[key]
    return tree if index is None else tree[index]


def lm_tree(named: Mapping[str, torch.Tensor], cfg: ArchConfig) -> Dict:
    """The JAX package's stacked LM params pytree from tensors keyed by the
    port's param names (``dict(params.named_parameters())``, or an
    optimizer moment keyed alike).  A decoder stack: ``embed``,
    ``final_norm``, ``lm_head`` where untied, and ``blocks``, a tuple of
    one dict a pattern slot whose leaves stack the slot's layers over
    periods.  An encoder-decoder stack: ``embed``, ``enc_pos``,
    ``enc_norm``, ``final_norm``, ``lm_head``, and ``enc_layers`` and
    ``dec_layers``, dicts whose leaves stack the layers."""
    p = cfg.pattern_period
    tree: Dict = {}
    stacks: Dict = {}
    for name, t in named.items():
        path, index = _lm_path(name, p)
        if index is None:
            tree[path[0]] = t
        else:
            stacks.setdefault(path, []).append((index, t))
    slots: Dict = {}
    for path, ts in stacks.items():
        node, rest = ((slots.setdefault(path[1], {}), path[2:])
                      if path[0] == "blocks" else
                      (tree.setdefault(path[0], {}), path[1:]))
        for key in rest[:-1]:
            node = node.setdefault(key, {})
        node[rest[-1]] = torch.stack([t for _, t in sorted(
            ts, key=lambda it: it[0])])
    if not cfg.is_encoder_decoder:
        tree["blocks"] = tuple(slots[s] for s in range(p))
    return tree


def lm_params_from_numpy(params: Mapping, cfg: ArchConfig, device="cpu"):
    """The port's LM params (a
    :class:`~repro_torch.models.transformer.Transformer`, or an
    :class:`~repro_torch.models.encdec.EncDec` for an encoder-decoder arch)
    from the JAX package's LM params pytree as numpy (see
    :func:`lm_tree` for its layout)."""
    from repro_torch.models import Model
    model = Model(cfg, device=device).init()
    with torch.no_grad():
        for name, dst in model.named_parameters():
            src = np.asarray(lm_leaf(params, name, cfg))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"param {name} of shape {src.shape} for "
                                 f"{tuple(dst.shape)}")
            dst.copy_(torch.from_numpy(np.array(src, copy=True)))
    return model


FED_MESH_HOST_INTS = ("ens_count", "counter", "last_sync", "sync_count")
FED_MESH_HOST_F32 = ("interval", "prev_err")


def fed_mesh_state_from_numpy(state: Mapping, device="cpu", key: int = 0):
    """The port's :class:`~repro_torch.core.fed_mesh.FedMeshState` from a
    mesh trainer's state as numpy, keyed by the reference's field names
    (``{k: np.asarray(v) for k, v in state._asdict().items()}``; its
    ``key`` is not read: the step draws nothing).  The client-split and
    ensemble leaves go to ``device`` with their dtypes, the round counters
    become host ints and the interval and previous error f32 scalar
    tensors on the host."""
    from repro_torch.core.fed_mesh import FedMeshState
    dev = resolve_device(device)
    fields = {}
    for name in FedMeshState._fields:
        if name == "key":
            fields[name] = int(key)
        elif name in FED_MESH_HOST_INTS:
            fields[name] = int(np.asarray(state[name]))
        elif name in FED_MESH_HOST_F32:
            fields[name] = torch.tensor(np.float32(state[name]), dtype=F32)
        else:
            a = np.asarray(state[name])
            fields[name] = torch.from_numpy(np.array(a, copy=True)).to(dev)
    return FedMeshState(**fields)


def fed_mesh_state_to_numpy(state) -> Dict[str, np.ndarray]:
    """A :class:`~repro_torch.core.fed_mesh.FedMeshState` as numpy under the
    reference's field names (``key`` left out): the counters as int32 and
    the interval and previous error as f32 scalars, as the reference holds
    them, every other leaf with its own dtype."""
    out = {}
    for name, v in state._asdict().items():
        if name == "key":
            continue
        if name in FED_MESH_HOST_INTS:
            out[name] = np.asarray(v, np.int32)
        else:
            out[name] = v.detach().cpu().numpy()
    return out
