# repro_torch.chain — the server-less FLchain mode (arXiv:2112.07938): client
# model deltas commit to a hash-linked chain whose confirmation times come
# from the BlockchainLedger slot model; a rotating rendezvous committee
# stamps blocks; every serving node folds the confirmed prefix into
# bit-identical EnsembleSnapshots.  ChainRegistry quacks as the central
# EnsembleRegistry so the training/publish hooks and the sharded serving
# fleet run unchanged — minus the single point of failure.
from repro_torch.chain.core import (  # noqa: F401
    Block, Chain, ChainCommit, GENESIS_HASH, block_hash)
from repro_torch.chain.registry import ChainRegistry  # noqa: F401
from repro_torch.chain.cluster import ChainCluster  # noqa: F401
