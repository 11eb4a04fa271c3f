"""Shared dataclass types for the Cost-TrustFL core."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np


@dataclass(frozen=True)
class CloudTopology:
    """Static client→cloud assignment.

    ``cloud_of[i]`` is the cloud index of client ``i``;
    ``aggregator_cloud`` is where the global aggregator lives (clients in
    that cloud pay ``c_intra`` to reach it, Eq. 2).
    """
    cloud_of: np.ndarray          # (N,) int
    n_clouds: int
    aggregator_cloud: int = 0

    @property
    def n_clients(self) -> int:
        return int(self.cloud_of.shape[0])

    @staticmethod
    def even(n_clouds: int, clients_per_cloud: int, aggregator_cloud: int = 0
             ) -> "CloudTopology":
        cloud_of = np.repeat(np.arange(n_clouds), clients_per_cloud)
        return CloudTopology(cloud_of=cloud_of, n_clouds=n_clouds,
                             aggregator_cloud=aggregator_cloud)


@dataclass
class RoundMetrics:
    """Per-round bookkeeping returned by servers."""
    round: int = 0
    loss: float = 0.0
    accuracy: float = 0.0
    cost: float = 0.0                 # $ this round (Eq. 1)
    cum_cost: float = 0.0             # Σ over rounds
    selected: Optional[np.ndarray] = None
    reputation: Optional[np.ndarray] = None
    trust: Optional[np.ndarray] = None
    extra: Optional[Dict[str, Any]] = None
