"""Hash-linked chain of committed model deltas: the FLchain record.

The blockchain scenarios used to treat the chain as a *delay model* —
:class:`~repro_torch.sim.behavior.BlockchainLedger` priced a commit's inclusion
wait and the payload still landed in a central registry.  Here the ledger
becomes load-bearing (the server-less design of arXiv:2112.07938): every
publish is cut into per-client :class:`ChainCommit` deltas (stump rows +
vote weights + ``cid``/round metadata), each commit reserves a slot on the
*shared* ledger and confirms when its block is mined, and the serving
ensemble is a pure fold over the confirmed prefix — any node replaying the
chain from genesis reconstructs byte-identical snapshots, so there is no
registry instance whose death loses state.

Three structural guarantees the property suite pins:

* **hash-link integrity** — every block's ``prev_hash`` is its parent's
  content hash (same blake2b construction as the snapshot fingerprint);
  mutating any commit breaks every descendant link.
* **deterministic replay** — block hashes are a pure function of the
  (height, parent, mined_at, commits) sequence: re-minting the recorded
  sequence from genesis reproduces the hash chain exactly.
* **confirmed-prefix monotonicity** — with ``reorg_prob > 0`` only the
  *unconfirmed tip* can be orphaned (its commits re-mint into the next
  block), so the confirmed prefix only ever extends.

A rotating committee (rendezvous rank over the joined participants,
reusing :func:`repro_torch.serve.shard.rendezvous_rank`) selects the miner that
stamps each block; mining is deterministic given the commit sequence, so
the leader dying mid-run only rotates the stamp — the fold is unchanged.
"""
from __future__ import annotations

import functools
import hashlib
import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.serve.shard import rendezvous_rank
from repro_torch.sim.behavior import BlockchainLedger

GENESIS_HASH = "0" * 24        # blake2b(digest_size=12) hexdigest width


@dataclass(frozen=True)
class ChainCommit:
    """One client's model delta as committed on chain.

    ``stump_params`` carries the packed ``(k, 4)`` stump rows (the fed_mesh
    wire format); non-stump families ship their params dicts (CPU tensors)
    in ``learners`` instead.  ``rounds`` are the client-local boosting rounds
    the entries were trained at — together with ``cid`` this is the
    provenance record ``provenance(tenant, version)`` answers from.
    """
    tenant: str
    cid: int                          # committing client (-1 = host/mesh)
    seq: int                          # global submission sequence number
    rounds: Tuple[int, ...]           # client-local round per entry
    alphas: Tuple[float, ...]         # compensated vote weights per entry
    stump_rows: Optional[Tuple[Tuple[float, ...], ...]] = None
    learners: Tuple = ()              # generic params dicts (non-stump)
    weak_name: str = "stump"
    train_progress: int = 0           # publisher's merged count at submit
    submitted_at: float = 0.0         # publisher clock at submission
    # trace context of the publishing node's chain.commit span.  Pure
    # observability metadata: excluded from equality and — critically —
    # from :attr:`fingerprint`, so traced and untraced replays mint
    # bit-identical hash chains.
    ctx: Optional[object] = field(default=None, compare=False, repr=False)

    @property
    def n_entries(self) -> int:
        return len(self.alphas)

    @functools.cached_property
    def fingerprint(self) -> str:
        """Content digest — the same blake2b construction as
        :attr:`EnsembleSnapshot.fingerprint`, extended with the commit
        identity (tenant/cid/seq/rounds) so two clients committing equal
        deltas still hash apart."""
        h = hashlib.blake2b(digest_size=12)
        h.update(self.tenant.encode())
        h.update(np.int64(self.cid).tobytes())
        h.update(np.int64(self.seq).tobytes())
        h.update(np.asarray(self.rounds, np.int64).tobytes())
        h.update(self.weak_name.encode())
        h.update(np.int64(self.train_progress).tobytes())
        h.update(np.asarray(self.alphas, np.float32).tobytes())
        if self.stump_rows is not None:
            h.update(np.asarray(self.stump_rows, np.float32).tobytes())
        for leaf in _tree_leaves(self.learners):
            h.update(np.ascontiguousarray(leaf).tobytes())
        return h.hexdigest()


def _tree_leaves(tree) -> List[np.ndarray]:
    """The leaves of a learners tuple as host numpy arrays, in the JAX
    package's pytree order: sequences in order, each dict's values in
    sorted key order, ``None`` holding no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in _tree_leaves(t)]
    if isinstance(tree, torch.Tensor):
        return [tree.detach().cpu().numpy()]
    return [np.asarray(tree)]


def block_hash(height: int, prev_hash: str, mined_at: float,
               commits: Sequence[ChainCommit]) -> str:
    """Content hash of one block — a pure function of (height, parent,
    mined time, commit fingerprints), so replaying the recorded sequence
    from genesis reproduces the chain bit for bit.  The miner stamp is
    deliberately *outside* the hash: committee membership at replay time
    (who re-mints) must not change what was recorded."""
    h = hashlib.blake2b(digest_size=12)
    h.update(np.int64(height).tobytes())
    h.update(prev_hash.encode())
    h.update(np.float64(mined_at).tobytes())
    for c in commits:
        h.update(c.fingerprint.encode())
    return h.hexdigest()


@dataclass(frozen=True)
class Block:
    """One mined block: hash-linked to its parent, carrying the commits
    confirmed at ``mined_at``."""
    height: int
    prev_hash: str
    mined_at: float
    commits: Tuple[ChainCommit, ...] = ()
    miner: str = ""                   # committee leader at mint (metadata)

    @functools.cached_property
    def hash(self) -> str:
        return block_hash(self.height, self.prev_hash, self.mined_at,
                          self.commits)


class Chain:
    """The shared chain of record.

    Commits queue on the :class:`BlockchainLedger` slot model — the same
    capacity serialization the behavior layer prices — and mint in
    confirmation order when :meth:`advance` moves the chain clock.  With
    ``reorg_prob > 0`` a freshly due block may orphan the unconfirmed tip
    (depth-1 fork): the tip's commits re-mint into the new block, nothing
    is lost, and the confirmed prefix (everything except the tip) only
    extends.  :meth:`finalize` settles the tail once training ends.
    """

    def __init__(self, ledger: Optional[BlockchainLedger] = None, *,
                 confirmations: int = 2, reorg_prob: float = 0.0,
                 committee_size: int = 3, epoch_blocks: int = 4,
                 seed: int = 0):
        self.ledger = ledger or BlockchainLedger(
            np.random.RandomState(seed * 7919 + 977))
        self.confirmations = int(confirmations)
        self.reorg_prob = float(reorg_prob)
        self.committee_size = int(committee_size)
        self.epoch_blocks = max(1, int(epoch_blocks))
        self._rng = np.random.RandomState(seed * 7919 + 978)
        self.blocks: List[Block] = [Block(0, GENESIS_HASH, 0.0)]
        self._pending: List[Tuple[float, int, ChainCommit]] = []
        self._seq = 0
        self._finalized = False
        self._participants: Dict[str, None] = {}   # ordered set
        self.reorgs = 0

    # -------------------------------------------------------- participants
    def join(self, node_id: str) -> None:
        self._participants[node_id] = None

    def leave(self, node_id: str) -> None:
        self._participants.pop(node_id, None)

    def participants(self) -> List[str]:
        return list(self._participants)

    def committee(self, height: Optional[int] = None) -> List[str]:
        """The aggregation committee for the epoch containing ``height``
        (default: the next block to be mined) — rendezvous rank over the
        joined participants, rotating every ``epoch_blocks`` blocks."""
        if not self._participants:
            return []
        h = self.height if height is None else int(height)
        epoch = h // self.epoch_blocks
        ranked = rendezvous_rank(f"committee|{epoch}", self._participants)
        return ranked[:self.committee_size]

    def leader(self, height: Optional[int] = None) -> Optional[str]:
        com = self.committee(height)
        return com[0] if com else None

    # ------------------------------------------------------------- commits
    def submit(self, commit: ChainCommit, t: float) -> float:
        """Queue a commit at publisher time ``t``: reserve the next free
        ledger slot (commits serialize on chain capacity) and wait the
        configured confirmation depth.  Returns the seconds until the
        commit is confirmed."""
        wait = (self.ledger.commit(t, cursor=self._cursor())
                + (self.confirmations - 1) * self.ledger.block_interval_s)
        heapq.heappush(self._pending, (t + wait, commit.seq, commit))
        obs.count("chain.pending")
        return wait

    def next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def _cursor(self):
        # the chain registers one ledger cursor lazily: submission times
        # from the event-driven engine are non-decreasing, which lets a
        # shared ledger prune slots the chain can no longer collide with
        cur = getattr(self, "_cursor_id", None)
        if cur is None:
            cur = self._cursor_id = self.ledger.register()
        return cur

    # -------------------------------------------------------------- mining
    @property
    def height(self) -> int:
        return self.blocks[-1].height

    def advance(self, now: float) -> List[Block]:
        """Mint every block whose confirmation time has passed, in
        confirmation order; returns the newly minted blocks."""
        minted: List[Block] = []
        while self._pending and self._pending[0][0] <= now:
            due, _, commit = heapq.heappop(self._pending)
            minted.append(self._mint(due, (commit,)))
        return minted

    def finalize(self) -> List[Block]:
        """Settle the chain: mint everything still pending at its recorded
        confirmation time (training is over; the mempool drains without
        further forks) and confirm the tip — after this the confirmed
        prefix is the whole chain."""
        self._finalized = True
        return self.advance(float("inf"))

    def _mint(self, mined_at: float, commits: Tuple[ChainCommit, ...]
              ) -> Block:
        parent = self.blocks[-1]
        if (self.reorg_prob > 0.0 and parent.height > 0
                and not self._finalized
                and self._rng.rand() < self.reorg_prob):
            # depth-1 fork: orphan the unconfirmed tip; its commits ride
            # along in the replacing block, so no delta is ever lost and
            # the confirmed prefix (blocks[:-1]) is untouched
            orphan = self.blocks.pop()
            commits = orphan.commits + commits
            parent = self.blocks[-1]
            self.reorgs += 1
            obs.count("chain.reorgs")
            if obs.enabled():
                obs.point("chain.reorg", sim_t0=mined_at, sim_t1=mined_at,
                          orphaned=orphan.hash, height=orphan.height,
                          commits=len(orphan.commits))
        block = Block(parent.height + 1, parent.hash, float(mined_at),
                      commits, miner=self.leader(parent.height + 1) or "")
        self.blocks.append(block)
        obs.count("chain.blocks")
        if obs.enabled():
            # the mint event links every included commit's publish trace:
            # commit -> mint -> registry fold stitches into one tree
            obs.point("chain.mint", sim_t0=mined_at, sim_t1=mined_at,
                      host=block.miner,
                      link=[c.ctx for c in commits if c.ctx is not None],
                      height=block.height, block=block.hash,
                      commits=len(commits))
        return block

    # ------------------------------------------------------------ reading
    @property
    def tail_depth(self) -> int:
        """Blocks held back from the confirmed prefix: with forks possible
        the tip is not final until a descendant (or finalize) lands."""
        return 0 if (self._finalized or self.reorg_prob == 0.0) else 1

    def confirmed_blocks(self) -> List[Block]:
        """The confirmed prefix (genesis excluded), oldest first."""
        end = len(self.blocks) - self.tail_depth
        return self.blocks[1:max(1, end)]

    def confirmed_hashes(self) -> List[str]:
        return [b.hash for b in self.confirmed_blocks()]

    # ---------------------------------------------------------- integrity
    def verify(self) -> bool:
        """Hash-link integrity of the whole chain: contiguous heights and
        every ``prev_hash`` equal to the parent's content hash."""
        if self.blocks[0].prev_hash != GENESIS_HASH:
            return False
        for i in range(1, len(self.blocks)):
            b, parent = self.blocks[i], self.blocks[i - 1]
            if b.height != parent.height + 1 or b.prev_hash != parent.hash:
                return False
        return True

    def replay_hashes(self) -> List[str]:
        """Re-mint the recorded (mined_at, commits) sequence from genesis
        with fresh :class:`Block` objects and return the resulting hash
        chain — deterministic replay means it equals the live chain's."""
        prev = self.blocks[0].hash      # the genesis block's content hash
        out = []
        for i, b in enumerate(self.blocks[1:], start=1):
            fresh = Block(i, prev, b.mined_at, b.commits)
            out.append(fresh.hash)
            prev = fresh.hash
        return out
