# Serving subsystem for federated boosted ensembles: training publishes
# immutable versioned snapshots into a multi-tenant registry; an adaptive
# micro-batcher (the paper's eq.-1 controller on a latency signal) packs
# request traffic across tenants into padded blocks for the batched stump
# vote kernels.  The sharded layer partitions tenants across hosts by
# rendezvous hashing and replicates snapshots with anti-entropy gossip;
# the result cache memoizes margins per (tenant, version, x-hash).
# FleetAutoscaler scales the host count on queue-depth/p99 pressure (the
# same eq.-1 controller), and PolicyTable resolves batching + kernel
# policies per (tenant, host).
from repro_torch.kernels.dispatch import KernelPolicy  # noqa: F401
from repro_torch.serve.registry import (  # noqa: F401
    EnsembleRegistry, EnsembleSnapshot, pack_stumps)
from repro_torch.serve.batching import (  # noqa: F401
    AdaptiveWindow, BatchConfig, MicroBatchQueue, Request, SERVE_SCHEDULER)
from repro_torch.serve.cache import (  # noqa: F401
    CacheStats, ResultCache, feature_hash)
from repro_torch.serve.engine import (  # noqa: F401
    BatchEvaluator, EvalStats, Response)
from repro_torch.serve.metrics import ServeMetrics, TenantMetrics  # noqa: F401
from repro_torch.serve.policy import PolicyTable  # noqa: F401
from repro_torch.serve.service import (  # noqa: F401
    EnsembleServer, ShardedEnsembleServer)
from repro_torch.serve.shard import (  # noqa: F401
    GossipConfig, GossipStats, ShardCluster, ShardHost,
    rendezvous_owner, rendezvous_rank, staleness_weight)
from repro_torch.serve.autoscale import (  # noqa: F401
    AutoscaleConfig, AutoscaleStats, FleetAutoscaler)
