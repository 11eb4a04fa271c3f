"""Cost-TrustFL core math on torch tensors.

Eq. 1–3  -> repro_torch.core.cost
Eq. 7    -> repro_torch.core.shapley
Eq. 8–9  -> repro_torch.core.reputation (the EMA runs in the engine)
Eq. 10   -> repro_torch.core.selection
Eq. 6    -> repro_torch.core.trust
Byzantine-robust baselines -> repro_torch.core.robust
update-level attacks      -> repro_torch.core.attacks
multi-feature trust gate  -> repro_torch.core.features
"""
from repro_torch.core import features
from repro_torch.core.attacks import UPDATE_ATTACKS, apply_update_attack
from repro_torch.core.cost import (CostModel, hierarchical_unit_costs_torch,
                                   round_bytes_torch)
from repro_torch.core.fl_types import CloudTopology, RoundMetrics
from repro_torch.core.reputation import ReputationState
from repro_torch.core.robust import (AGGREGATORS, coordinate_median, fedavg,
                                     fltrust, krum, trimmed_mean)
from repro_torch.core.selection import (exploration_quota, select_clients,
                                        selected_count)
from repro_torch.core.shapley import gradient_contribution
from repro_torch.core.trust import cloud_trust

__all__ = ["CostModel", "hierarchical_unit_costs_torch", "round_bytes_torch",
           "CloudTopology", "RoundMetrics", "ReputationState",
           "exploration_quota", "select_clients", "selected_count",
           "gradient_contribution", "cloud_trust", "UPDATE_ATTACKS",
           "apply_update_attack", "features", "AGGREGATORS", "fedavg",
           "krum", "trimmed_mean", "coordinate_median", "fltrust"]
