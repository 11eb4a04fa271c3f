"""Reputation normalization + EMA smoothing (Eq. 8–9). The round engine
and the host twin run both inside the fused ``trust_stage`` kernel;
these are the plain forms."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

Tensor = torch.Tensor


class ReputationState(NamedTuple):
    """Persistent per-client reputation r̂ (Eq. 9). ``ema`` has shape (N,)."""
    ema: Tensor

    @staticmethod
    def init(n_clients: int, *, device: torch.device,
             dtype: torch.dtype = torch.float32) -> "ReputationState":
        # Algorithm 1 line 1: r̂_i^(0) = 1/N
        return ReputationState(ema=torch.full((n_clients,), 1.0 / n_clients,
                                              dtype=dtype, device=device))


def normalize_scores(phi: Tensor, eps: float = 1e-12) -> Tensor:
    """Eq. 8: r_i = φ_i / Σ_j φ_j (uniform if all-zero)."""
    total = torch.sum(phi)
    uniform = torch.full_like(phi, 1.0 / phi.shape[0])
    return torch.where(total > eps, phi / torch.clamp(total, min=eps),
                       uniform)


def ema_update(state: ReputationState, r: Tensor, gamma: float,
               participated: Optional[Tensor] = None) -> ReputationState:
    """Eq. 9: r̂^(t) = γ·r̂^(t-1) + (1-γ)·r^(t); with ``participated``
    (bool (N,)) only the clients selected this round move."""
    new = gamma * state.ema + (1.0 - gamma) * r
    if participated is not None:
        new = torch.where(participated, new, state.ema)
    return ReputationState(ema=new)
