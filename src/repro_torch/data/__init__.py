from repro_torch.data.synthetic import make_domain_data  # noqa: F401
from repro_torch.data.partition import (  # noqa: F401
    dirichlet_partition, label_shard_partition, iid_partition)
