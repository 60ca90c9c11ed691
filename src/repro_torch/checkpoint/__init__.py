from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    save, restore, latest_step, prune)
