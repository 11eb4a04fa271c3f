"""Reputation state (Eq. 8–9). The EMA update itself runs inside the
round engine, next to the Eq. 7 scores it consumes."""
from __future__ import annotations

from typing import NamedTuple

import torch


class ReputationState(NamedTuple):
    """Persistent per-client reputation r̂ (Eq. 9). ``ema`` has shape (N,)."""
    ema: torch.Tensor

    @staticmethod
    def init(n_clients: int, *, device: torch.device,
             dtype: torch.dtype = torch.float32) -> "ReputationState":
        # Algorithm 1 line 1: r̂_i^(0) = 1/N
        return ReputationState(ema=torch.full((n_clients,), 1.0 / n_clients,
                                              dtype=dtype, device=device))
