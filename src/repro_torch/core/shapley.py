"""The paper's lightweight contribution score (Eq. 7). The round engine
computes it inside the fused ``trust_stage`` kernel (``trust_score`` is
that kernel's standalone mode); this is the plain form."""
from __future__ import annotations

from typing import Optional

import torch


def gradient_contribution(last_layer_grads: torch.Tensor,
                          mean_grad: Optional[torch.Tensor] = None,
                          eps: float = 1e-12) -> torch.Tensor:
    """Eq. 7: φ_i = ReLU(cos(g_i, ḡ)) · ‖g_i‖₂ over (N, D) rows;
    ``mean_grad`` defaults to the mean over rows."""
    g = last_layer_grads.reshape(last_layer_grads.shape[0], -1)
    gbar = g.mean(dim=0) if mean_grad is None else mean_grad.reshape(-1)
    dots = g @ gbar
    norms = torch.linalg.vector_norm(g, dim=1)
    nbar = torch.linalg.vector_norm(gbar)
    cos = dots / torch.clamp(norms * nbar, min=eps)
    return torch.relu(cos) * norms
