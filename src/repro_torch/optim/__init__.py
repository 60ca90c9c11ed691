from repro_torch.optim.optimizers import (  # noqa: F401
    Optimizer, sgd, adam, adamw, get_optimizer, clip_by_global_norm,
    global_norm, constant_schedule, cosine_schedule, linear_schedule)
