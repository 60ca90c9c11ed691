"""Property-based suite for the port's chain of record, held to the JAX
package's: hash-link integrity under arbitrary commit sequences and
tampering, deterministic replay from genesis, and confirmed-prefix
monotonicity under reorgs and committee rotation (the JAX package's
``tests/test_chain_properties.py``).  Every case runs on both packages
from the same draws: the block hashes, confirmed prefixes, reorg counts
and committees must be equal."""
import pytest

pytest.importorskip("torch")
pytest.importorskip("hypothesis")

from hypothesis import given, settings, strategies as st  # noqa: E402

import repro.chain as J  # noqa: E402
import repro_torch.chain as T  # noqa: E402

NODES = ("n0", "n1", "n2", "n3", "n4")


def _commit(mod, seq, tenant, cid, k):
    return mod.ChainCommit(
        tenant=tenant, cid=cid, seq=seq, rounds=tuple(range(k)),
        alphas=tuple(0.5 + 0.25 * i for i in range(k)),
        stump_rows=tuple((float(seq), float(i), 1.0, 0.0)
                         for i in range(k)))


submissions = st.lists(
    st.tuples(st.sampled_from(("alpha", "beta")),   # tenant
              st.integers(0, 9),                    # committing client
              st.integers(1, 3),                    # entries in the delta
              st.floats(0.0, 4.0)),                 # inter-submit gap (s)
    min_size=1, max_size=16)


def _feed(mod, chain, events):
    t = 0.0
    waits = []
    for tenant, cid, k, gap in events:
        t += gap                                    # publisher-monotone
        waits.append(chain.submit(_commit(mod, chain.next_seq(), tenant,
                                          cid, k), t))
    return t, waits


def _hashes(chain):
    return [b.hash for b in chain.blocks]


# ------------------------------------------------------ hash-link integrity
@given(events=submissions, seed=st.integers(0, 99))
@settings(max_examples=40, deadline=None)
def test_hash_links_verify_and_tamper_breaks_them(events, seed):
    out = []
    for mod in (J, T):
        chain = mod.Chain(seed=seed)
        _, waits = _feed(mod, chain, events)
        chain.finalize()
        assert chain.verify()
        assert len(chain.blocks) == len(events) + 1
        for i in range(1, len(chain.blocks) - 1):
            good = chain.blocks[i]
            chain.blocks[i] = mod.Block(good.height, good.prev_hash,
                                        good.mined_at + 0.5, good.commits)
            assert not chain.verify()
            chain.blocks[i] = good
        tip = chain.blocks[-1]
        chain.blocks[-1] = mod.Block(tip.height, "f" * 24, tip.mined_at,
                                     tip.commits)
        assert not chain.verify()
        chain.blocks[-1] = tip
        assert chain.verify()
        out.append((waits, _hashes(chain)))
    assert out[0] == out[1]


# ---------------------------------------------------- deterministic replay
@given(events=submissions, seed=st.integers(0, 99),
       reorg=st.floats(0.0, 0.5))
@settings(max_examples=40, deadline=None)
def test_replay_from_genesis_reproduces_hashes(events, seed, reorg):
    out = []
    for mod in (J, T):
        a = mod.Chain(seed=seed, reorg_prob=reorg)
        b = mod.Chain(seed=seed, reorg_prob=reorg)
        a.join("only-on-a")
        for n in NODES:
            b.join(n)
        _feed(mod, a, events)
        _feed(mod, b, events)
        a.finalize()
        b.finalize()
        live = [blk.hash for blk in a.blocks[1:]]
        assert a.replay_hashes() == live
        assert [blk.hash for blk in b.blocks[1:]] == live
        out.append((live, a.reorgs, [blk.miner for blk in b.blocks]))
    assert out[0] == out[1]


# ----------------------------------------- confirmed-prefix monotonicity
@given(events=submissions, seed=st.integers(0, 99),
       churn=st.lists(st.sampled_from(NODES), max_size=6),
       reorg=st.floats(0.0, 0.6))
@settings(max_examples=40, deadline=None)
def test_confirmed_prefix_only_extends(events, seed, churn, reorg):
    out = []
    for mod in (J, T):
        chain = mod.Chain(seed=seed, reorg_prob=reorg, committee_size=2)
        for n in NODES:
            chain.join(n)
        t_end, _ = _feed(mod, chain, events)
        confirmed, seen = [], []
        t = 0.0
        for i, node in enumerate(churn or [NODES[0]]):
            (chain.leave if i % 2 else chain.join)(node)
            t += t_end / 4 + 0.5
            chain.advance(t)
            now = chain.confirmed_hashes()
            assert now[:len(confirmed)] == confirmed
            confirmed = now
            seen.append((now, chain.committee(), chain.leader()))
        chain.finalize()
        final = chain.confirmed_hashes()
        assert final[:len(confirmed)] == confirmed
        assert chain.verify()
        seqs = sorted(c.seq for b in chain.blocks for c in b.commits)
        assert seqs == list(range(1, len(events) + 1))
        out.append((seen, final, chain.reorgs,
                    [b.miner for b in chain.blocks]))
    assert out[0] == out[1]
