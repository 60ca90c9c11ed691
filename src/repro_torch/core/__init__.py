# The paper's primary contribution: adaptive communication scheduling,
# delayed weight compensation, buffer-based sync — plus the async federated
# boosting engine.
from repro_torch.core.scheduling import HostScheduler  # noqa: F401
from repro_torch.core.compensation import (  # noqa: F401
    adaboost_alpha, compensate, compensated_alpha)
from repro_torch.core.boosting import (  # noqa: F401
    Ensemble, fit_adaboost, weighted_error, update_distribution,
    ensemble_margin, ensemble_predict, accuracy)
from repro_torch.core.async_engine import (  # noqa: F401
    FederatedBoostEngine, RunMetrics)
