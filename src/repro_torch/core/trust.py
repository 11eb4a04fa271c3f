"""Cloud-level trust for the cross-cloud phase (Eq. 6)."""
from __future__ import annotations

import torch


def cloud_trust(cloud_grads: torch.Tensor, global_ref: torch.Tensor,
                eps: float = 1e-12) -> torch.Tensor:
    """β_k (Eq. 6 / Algorithm 1 line 16): ReLU'd cosine of each cloud
    aggregate against the global reference direction, normalized to sum
    1 (uniform when every cosine is ≤ 0)."""
    g = cloud_grads.reshape(cloud_grads.shape[0], -1)
    ref = global_ref.reshape(-1)
    cos = (g @ ref) / torch.clamp(
        torch.linalg.vector_norm(g, dim=1) * torch.linalg.vector_norm(ref),
        min=eps)
    beta = torch.relu(cos)
    total = torch.sum(beta)
    k = g.shape[0]
    return torch.where(total > eps, beta / torch.clamp(total, min=eps),
                       torch.full((k,), 1.0 / k, dtype=g.dtype,
                                  device=g.device))
