"""FLTrust-style trust scoring and aggregation (Eq. 11–13) on flattened
update matrices, the cloud-level trust of the cross-cloud phase (Eq. 6),
and the same dot products on dicts of tensors (the ``tree_*`` helpers).
The round engine and the host twin run Eq. 11 in the ``trust_stage``
kernel and Eq. 12–13 in ``weighted_agg``; these are the plain forms."""
from __future__ import annotations

from typing import Dict

import torch

Tensor = torch.Tensor
Tree = Dict[str, Tensor]


def trust_scores(last_layer_grads: Tensor, ref_last_layer: Tensor,
                 reputation: Tensor, eps: float = 1e-12) -> Tensor:
    """Eq. 11: TS_i = ReLU(cos(g_i^(L), g_ref^(L))) · r̂_i."""
    g = last_layer_grads.reshape(last_layer_grads.shape[0], -1)
    ref = ref_last_layer.reshape(-1)
    cos = (g @ ref) / torch.clamp(torch.linalg.vector_norm(g, dim=1)
                                  * torch.linalg.vector_norm(ref), min=eps)
    return torch.relu(cos) * reputation


def normalize_updates(grads: Tensor, ref_grad: Tensor,
                      eps: float = 1e-12) -> Tensor:
    """Eq. 12: g̃_i = (‖g_ref‖₂ / ‖g_i‖₂) · g_i  (rows of (N, D))."""
    g = grads.reshape(grads.shape[0], -1)
    norms = torch.linalg.vector_norm(g, dim=1, keepdim=True)
    refn = torch.linalg.vector_norm(ref_grad.reshape(-1))
    return (g * (refn / torch.clamp(norms, min=eps))).reshape(grads.shape)


def trusted_aggregate(grads: Tensor, ts: Tensor, eps: float = 1e-12
                      ) -> Tensor:
    """Eq. 13: Σ TS_i·g̃_i / Σ TS_i (g̃ already normalized)."""
    g = grads.reshape(grads.shape[0], -1)
    w = ts / torch.clamp(torch.sum(ts), min=eps)
    return (w @ g).reshape(grads.shape[1:])


def cloud_trust(cloud_grads: Tensor, global_ref: Tensor,
                eps: float = 1e-12) -> Tensor:
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


# ---------------------------------------------------------------------------
# the same on dicts of tensors (leaves matched by key)

def tree_dot(a: Tree, b: Tree) -> Tensor:
    """Σ over leaves of ⟨a, b⟩ (sorted keys), each leaf upcast to float32
    first."""
    return sum(torch.sum(a[k].to(torch.float32) * b[k].to(torch.float32))
               for k in sorted(a))


def tree_norm(t: Tree) -> Tensor:
    return torch.sqrt(torch.clamp(tree_dot(t, t), min=0.0))


def tree_cos(a: Tree, b: Tree, eps: float = 1e-12) -> Tensor:
    return tree_dot(a, b) / torch.clamp(tree_norm(a) * tree_norm(b), min=eps)


def tree_scale(t: Tree, s) -> Tree:
    """Each leaf times ``s`` in float32, back in the leaf's dtype."""
    return {k: (v.to(torch.float32) * s).to(v.dtype) for k, v in t.items()}
