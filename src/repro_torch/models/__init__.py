from repro_torch.models.model_api import Model  # noqa: F401
