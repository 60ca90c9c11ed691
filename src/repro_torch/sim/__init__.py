# repro_torch.sim — trace-driven client-heterogeneity simulation: the
# ClientBehavior device/link models under the federated engines, the
# scenario registry binding the five paper domains (+ stress variants) to
# partitioners/behavior mixes/paper bands, and the train half of the
# scenario harness.
#
# The harness is imported lazily (PEP 562): it depends on
# repro_torch.core, while repro_torch.core.async_engine imports
# repro_torch.sim.behavior — eager re-export here would close that cycle.
from repro_torch.sim.behavior import (  # noqa: F401
    BlockchainLedger, BlockDelayBehavior, ClientBehavior, DiurnalBehavior,
    GilbertLinkBehavior, LegacyBehavior, Link, SiteBehavior,
    SiteOutageProcess, TraceSchedule, legacy_behaviors)
from repro_torch.sim.scenarios import (  # noqa: F401
    DOMAINS, PAPER_BANDS, SCENARIOS, PaperBand, Scenario, base_scenarios,
    get_scenario, register, variant_scenarios)

_HARNESS_NAMES = ("ScenarioReport", "run_scenario", "train_pair",
                  "result_row", "summarize")


def __getattr__(name: str):
    if name in _HARNESS_NAMES:
        from repro_torch.sim import harness
        return getattr(harness, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
