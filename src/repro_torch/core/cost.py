"""Communication cost model (paper §III-C, Eq. 1–3) with byte-exact
per-link payloads.

``CostModel`` is numpy float64, a copy of the reference's, so the $ and
byte figures of the port equal the reference's exactly. The torch
functions at the bottom mirror the reference's jittable accounting: the
round engine carries float32 running totals in its state, while
``FLServer`` re-derives float64 totals on the host from the delivered
masks.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple, Union

import numpy as np
import torch

from repro_torch.core.fl_types import CloudTopology

_GB = 1024.0 ** 3

PayloadLike = Union[None, int, float, np.ndarray]


def _as_payload(payload: PayloadLike, n: int, default: float) -> np.ndarray:
    """Broadcast a scalar/array payload spec to a float64 (n,) vector."""
    if payload is None:
        return np.full(n, default, np.float64)
    return np.broadcast_to(np.asarray(payload, np.float64), (n,)).copy()


@dataclass(frozen=True)
class CostModel:
    c_intra: float = 0.01     # $/GB within a cloud
    c_cross: float = 0.09     # $/GB cross-cloud egress
    bytes_per_param: int = 4

    def client_unit_costs(self, topo: CloudTopology) -> np.ndarray:
        """c_i (Eq. 2): the $/GB for client i to reach the global
        aggregator's cloud on the flat upload path."""
        same = topo.cloud_of == topo.aggregator_cloud
        return np.where(same, self.c_intra, self.c_cross)

    def _edge_prices(self, topo: CloudTopology) -> np.ndarray:
        """(K,) $/GB of each cloud's edge→global uplink."""
        prices = np.full(topo.n_clouds, self.c_cross, np.float64)
        prices[topo.aggregator_cloud] = self.c_intra
        return prices

    def hierarchical_unit_costs(self, topo: CloudTopology) -> np.ndarray:
        """Marginal per-client cost under hierarchical aggregation: the
        intra-cloud upload plus the cloud's edge→global upload amortized
        over its clients — the c_i Eq. 10 sees inside Cost-TrustFL."""
        sizes = np.bincount(topo.cloud_of, minlength=topo.n_clouds)
        amortized = self._edge_prices(topo) / np.maximum(sizes, 1)
        return self.c_intra + amortized[topo.cloud_of]

    def round_bytes(self, topo: CloudTopology, selected: np.ndarray,
                    d_params: int, *, hierarchical: bool = True,
                    client_payload: PayloadLike = None,
                    edge_payload: PayloadLike = None
                    ) -> Tuple[float, float]:
        """Exact (intra_bytes, cross_bytes) on the wire for one round.

        ``client_payload``: bytes of one client uplink — scalar or (N,);
        defaults to ``bytes_per_param * d_params`` (fp32).
        ``edge_payload``: bytes of one edge→global uplink — scalar or
        (K,); hierarchical path only. The aggregator cloud's edge uplink
        is co-located, so its bytes count as *intra* traffic.
        """
        full = float(self.bytes_per_param) * d_params
        sel = np.asarray(selected, bool)
        cp = _as_payload(client_payload, topo.n_clients, full)
        if not hierarchical:
            same = topo.cloud_of == topo.aggregator_cloud
            return (float(cp[sel & same].sum()),
                    float(cp[sel & ~same].sum()))
        intra = float(cp[sel].sum())                 # client -> edge
        active = np.bincount(topo.cloud_of[sel],
                             minlength=topo.n_clouds) > 0
        ep = _as_payload(edge_payload, topo.n_clouds, full) * active
        cross = float(ep.sum() - ep[topo.aggregator_cloud])
        intra += float(ep[topo.aggregator_cloud])
        return intra, cross

    def bytes_per_round(self, topo: CloudTopology, selected: np.ndarray,
                        d_params: int, *, hierarchical: bool = True,
                        client_payload: PayloadLike = None,
                        edge_payload: PayloadLike = None
                        ) -> Dict[str, float]:
        """One round's traffic in bytes: {"intra", "cross", "total"}."""
        intra, cross = self.round_bytes(
            topo, selected, d_params, hierarchical=hierarchical,
            client_payload=client_payload, edge_payload=edge_payload)
        return {"intra": intra, "cross": cross, "total": intra + cross}

    def round_cost(self, topo: CloudTopology, selected: np.ndarray,
                   d_params: int, hierarchical: bool = True, *,
                   client_payload: PayloadLike = None,
                   edge_payload: PayloadLike = None) -> float:
        """$ cost of one round (Eq. 1 flat, or the hierarchical variant)."""
        intra_b, cross_b = self.round_bytes(
            topo, selected, d_params, hierarchical=hierarchical,
            client_payload=client_payload, edge_payload=edge_payload)
        return float((intra_b * self.c_intra + cross_b * self.c_cross) / _GB)

    def full_participation_cost(self, topo: CloudTopology,
                                d_params: int) -> float:
        """Eq. 3 upper bound: Σ_k n_k·d·C_intra + K·d·C_cross."""
        gb = d_params * self.bytes_per_param / _GB
        return float(gb * self.c_intra * topo.n_clients +
                     gb * self.c_cross * topo.n_clouds)

    def collective_egress_dollars(self, cross_pod_bytes: int) -> float:
        """$ of measured cross-pod collective traffic at the egress rate
        (the dry-run records' cross-pod bytes, priced as the paper's
        cross-cloud fee)."""
        return cross_pod_bytes / _GB * self.c_cross


# ---------------------------------------------------------------------------
# torch mirrors of the reference's jittable accounting (float32)

def round_bytes_torch(delivered: torch.Tensor, cloud_of: torch.Tensor,
                      aggregator_cloud: int, client_payload: torch.Tensor,
                      edge_payload: torch.Tensor, *,
                      hierarchical: bool = True
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(intra_bytes, cross_bytes) of one round as float32 scalars.

    ``delivered``: (N,) bool participation; ``cloud_of`` (N,) int64;
    payloads (N,) and (K,) float32 on the same device."""
    w = delivered.to(torch.float32)
    cp = client_payload.to(torch.float32)
    same = (cloud_of == aggregator_cloud).to(torch.float32)
    if not hierarchical:
        return torch.sum(cp * w * same), torch.sum(cp * w * (1.0 - same))
    ep = edge_payload.to(torch.float32)
    k = ep.shape[0]
    per_cloud = torch.zeros(k, dtype=torch.float32,
                            device=w.device).index_add_(0, cloud_of, w)
    ep = ep * (per_cloud > 0).to(torch.float32)
    intra = torch.sum(cp * w) + ep[aggregator_cloud]
    cross = torch.sum(ep) - ep[aggregator_cloud]
    return intra, cross


def hierarchical_unit_costs_torch(cloud_of: torch.Tensor,
                                  cloud_sizes: np.ndarray,
                                  aggregator_cloud: int, c_intra: float,
                                  c_cross: float) -> torch.Tensor:
    """:meth:`CostModel.hierarchical_unit_costs` in float32 on
    ``cloud_of``'s device (the Eq. 10 marginal per-client cost)."""
    dev = cloud_of.device
    sizes = torch.as_tensor(np.asarray(cloud_sizes), dtype=torch.float32,
                            device=dev)
    k = sizes.shape[0]
    prices = torch.full((k,), c_cross, dtype=torch.float32, device=dev)
    prices[aggregator_cloud] = c_intra
    amortized = prices / torch.clamp(sizes, min=1.0)
    return c_intra + amortized[cloud_of]
