"""Cost-TrustFL core math on torch tensors.

Eq. 1–3  -> repro_torch.core.cost
Eq. 7    -> repro_torch.core.shapley
Eq. 8–9  -> repro_torch.core.reputation
Eq. 10   -> repro_torch.core.selection
Eq. 11–13, Eq. 6 -> repro_torch.core.trust
Alg. 1   -> repro_torch.core.aggregation (matrix form, the host twin) /
            repro_torch.federated.engine (the round engine)
Byzantine-robust baselines -> repro_torch.core.robust
update-level attacks      -> repro_torch.core.attacks
multi-feature trust gate  -> repro_torch.core.features
"""
from repro_torch.core import features
from repro_torch.core.aggregation import (AggregationResult,
                                          cost_trustfl_aggregate)
from repro_torch.core.attacks import (ATTACKS, UPDATE_ATTACKS,
                                      apply_update_attack, flip_labels,
                                      register_update_attack)
from repro_torch.core.cost import (CostModel, hierarchical_unit_costs_torch,
                                   round_bytes_torch)
from repro_torch.core.fl_types import CloudTopology, RoundMetrics
from repro_torch.core.reputation import (ReputationState, ema_update,
                                         normalize_scores)
from repro_torch.core.robust import (AGGREGATORS, coordinate_median, fedavg,
                                     fltrust, krum, trimmed_mean)
from repro_torch.core.selection import (exploration_quota, select_clients,
                                        select_clients_host, selected_count)
from repro_torch.core.shapley import (cosine_utility, exact_shapley,
                                      gradient_contribution,
                                      monte_carlo_shapley)
from repro_torch.core.trust import (cloud_trust, normalize_updates,
                                    tree_cos, tree_dot, tree_norm,
                                    tree_scale, trust_scores,
                                    trusted_aggregate)

__all__ = ["AggregationResult", "cost_trustfl_aggregate", "CostModel",
           "hierarchical_unit_costs_torch", "round_bytes_torch",
           "CloudTopology", "RoundMetrics", "ReputationState", "ema_update",
           "normalize_scores", "exploration_quota", "select_clients",
           "select_clients_host", "selected_count", "cosine_utility",
           "exact_shapley", "gradient_contribution", "monte_carlo_shapley",
           "cloud_trust", "normalize_updates", "trust_scores",
           "trusted_aggregate", "tree_cos", "tree_dot", "tree_norm",
           "tree_scale", "ATTACKS", "UPDATE_ATTACKS", "apply_update_attack",
           "flip_labels", "register_update_attack", "features",
           "AGGREGATORS", "fedavg", "krum", "trimmed_mean",
           "coordinate_median", "fltrust"]
