# Hand-written CUDA kernels for the port's hot spots.  csrc/*.cu: the
# kernels; build.py: nvcc at first use + ctypes binding; ref.py: the plain
# PyTorch versions; ops.py: the public entry points, where the tensor's
# device picks the kernel (CUDA) or the plain version (CPU).
from repro_torch.kernels.ops import (  # noqa: F401
    LAUNCHES, KernelPolicy, dist_update, ensemble_vote, ensemble_vote_batched,
    reset_launches, stump_scan, stump_vote_batched, stump_vote_fp_batched)
