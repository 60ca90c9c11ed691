"""The five paper domains' environment tables.

Each :class:`~repro_torch.configs.paper_fedboost.DomainConfig` fixes one
domain's published size (samples, features, clients), its label skew and
class balance, and the scalar client-heterogeneity knobs the legacy
behavior model reads.  The scenario registry that binds a domain to
behavior traces and paper bands comes with the scenario harness; the
tables themselves are the same values.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.paper_fedboost import DomainConfig

DOMAINS: Dict[str, DomainConfig] = {
    # smart-city cameras, rack-correlated failures
    "edge_vision": DomainConfig(
        name="edge_vision", n_samples=4000, n_features=64, n_clients=12,
        noniid_alpha=0.5, label_imbalance=0.5, noise=0.15,
        straggler_factor=5.0, dropout_prob=0.10, link_mbps=8.0),
    # on-chain federated marketplace, confirmation-delayed links
    "blockchain": DomainConfig(
        name="blockchain", n_samples=5000, n_features=32, n_clients=8,
        noniid_alpha=1.0, label_imbalance=0.45, noise=0.20,
        straggler_factor=2.0, dropout_prob=0.02, link_mbps=2.0),
    # keyboard personalization fleet, diurnal availability
    "mobile": DomainConfig(
        name="mobile", n_samples=6000, n_features=48, n_clients=32,
        noniid_alpha=0.2, label_imbalance=0.5, noise=0.18,
        straggler_factor=6.0, dropout_prob=0.15, link_mbps=5.0),
    # anomaly detection on battery sensors, bursty LPWAN links
    "iot": DomainConfig(
        name="iot", n_samples=4000, n_features=24, n_clients=24,
        noniid_alpha=0.3, label_imbalance=0.15, noise=0.10,
        straggler_factor=3.0, dropout_prob=0.12, link_mbps=1.0),
    # six hospitals, imbalanced diagnoses, maintenance windows
    "healthcare": DomainConfig(
        name="healthcare", n_samples=3000, n_features=40, n_clients=6,
        noniid_alpha=0.8, label_imbalance=0.20, noise=0.12,
        straggler_factor=2.5, dropout_prob=0.03, link_mbps=20.0),
}
