# Hand-written CUDA kernels for the port's hot spots.  csrc/*.cu: the
# kernels; build.py: nvcc at first use + ctypes binding; ref.py: the plain
# PyTorch versions; dispatch.py: backend selection (cuda / torch) with
# shape-bucketed calibration; ops.py: the public entry points, all routed
# through the dispatcher, and the cuda backend's launch code.
from repro_torch.kernels.dispatch import (  # noqa: F401
    BACKENDS, KernelPolicy, available_backends, bucket_of, default_policy,
    set_default_policy)
from repro_torch.kernels.ops import (  # noqa: F401
    LAUNCHES, dist_update, ensemble_vote, ensemble_vote_batched,
    flash_attention, reset_launches, stump_scan, stump_scan_batched,
    stump_vote_batched, stump_vote_fp_batched)
