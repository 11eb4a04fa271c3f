"""Cost-aware client selection (Eq. 10) with the paper's λ trade-off.

S = argmax_{|S|<=m} Σ_{i∈S} r̂_i / c_i^λ — separable, so the exact optimum
is the top-m of the ratio, here with the per-cloud exploration quota and
the multiplicative tie-break noise. ``select_clients`` is the tensor form
of the reference's jittable variant, which the round engine and the LLM
train steps run; its noise is an input (the caller draws it or replays
the reference's draw). Among exact ties it keeps ``lax.top_k``'s order,
the lower index first: the LLM steps select without noise, and there a
uniform reputation over clouds of equal unit costs ties whole clouds.
``select_clients_host`` is the numpy form the host round loop runs,
drawing its noise from the round's ``np.random.Generator``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def exploration_quota(cost_lambda: float) -> int:
    """Per-cloud exploration quota for Cost-TrustFL selection (2 below
    λ=0.75, else 0)."""
    return 2 if cost_lambda < 0.75 else 0


def selected_count(n: int, m: int, per_cloud_min: int = 0,
                   cloud_of: Optional[np.ndarray] = None) -> int:
    """Static size of the selected set: max(min(m, n), Σ_k min(quota,
    n_k)), a pure function of the topology."""
    m = min(m, n)
    if not per_cloud_min or cloud_of is None:
        return m
    cloud_of = np.asarray(cloud_of)
    quota = sum(min(per_cloud_min, int((cloud_of == k).sum()))
                for k in np.unique(cloud_of))
    return max(m, quota)


def _top(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries of ``x``, the lower index
    first among equal values (``lax.top_k``'s order; ``torch.topk``
    promises none): a stable descending sort."""
    return torch.sort(x, descending=True, stable=True).indices[:k]


def select_clients(reputation: torch.Tensor, unit_costs: torch.Tensor,
                   m: int, cost_lambda: float = 1.0, *,
                   per_cloud_min: int = 0,
                   cloud_of: Optional[np.ndarray] = None,
                   noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Boolean (N,) mask: the top-m of r̂/c^λ, after the per-cloud quota.

    ``noise`` (N,) standard normals scale the ratio by (1 + 1e-4·noise),
    the reference's exploration tie-break. ``cloud_of`` is a static
    numpy assignment, so the quotas and the fill count are fixed."""
    ratio = reputation / unit_costs ** cost_lambda
    if noise is not None:
        ratio = ratio * (1.0 + 1e-4 * noise.to(ratio.dtype))
    n = ratio.shape[0]
    m = min(m, n)
    chosen = torch.zeros(n, dtype=torch.bool, device=ratio.device)
    if not per_cloud_min or cloud_of is None:
        chosen[_top(ratio, m)] = True
        return chosen
    cloud_of = np.asarray(cloud_of)
    neg_inf = torch.tensor(-float("inf"), dtype=ratio.dtype,
                           device=ratio.device)
    quota_total = 0
    for k in np.unique(cloud_of):
        in_k = torch.as_tensor(cloud_of == k, device=ratio.device)
        q = min(per_cloud_min, int(in_k.sum()))
        quota_total += q
        chosen[_top(torch.where(in_k, ratio, neg_inf), q)] = True
    remaining = m - quota_total
    if remaining > 0:
        masked = torch.where(chosen, neg_inf, ratio)
        chosen[_top(masked, remaining)] = True
    return chosen


def select_clients_host(reputation: np.ndarray, unit_costs: np.ndarray,
                        m: int, per_cloud_min: int = 0,
                        cloud_of: Optional[np.ndarray] = None,
                        cost_lambda: float = 1.0,
                        rng: Optional[np.random.Generator] = None
                        ) -> np.ndarray:
    """Boolean (N,) mask of the selected set, in numpy: a copy of the
    reference's ``repro.core.selection.select_clients``. ``rng`` draws
    ``standard_normal(N)`` for the (1 + 1e-4·noise) tie-break; with a
    float32 ``reputation`` over float64 ``unit_costs`` the ratio is
    float64, as in the reference."""
    ratio = np.asarray(reputation) / np.asarray(unit_costs) ** cost_lambda
    if rng is not None:
        ratio = ratio * (1.0 + 1e-4 * rng.standard_normal(ratio.shape))
    n = ratio.shape[0]
    m = min(m, n)
    chosen = np.zeros(n, bool)
    if per_cloud_min and cloud_of is not None:
        for k in np.unique(cloud_of):
            idx = np.nonzero(cloud_of == k)[0]
            chosen[idx[np.argsort(-ratio[idx])[:per_cloud_min]]] = True
    remaining = m - chosen.sum()
    if remaining > 0:
        order = np.argsort(-np.where(chosen, -np.inf, ratio))
        chosen[order[:remaining]] = True
    return chosen
