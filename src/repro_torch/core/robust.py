"""Byzantine-robust aggregation baselines the paper compares against:
FedAvg [1], Krum / Multi-Krum [6], coordinate-wise Trimmed-Mean and
Median [7], and FLTrust [8] (the port of ``repro/core/robust.py``).
Each takes an (N, D) update matrix (rows = clients) and returns the (D,)
aggregate.

FLTrust's rescaled, trust-weighted sum is the ``weighted_agg`` kernel's
own function with one segment, so it runs through that kernel on the
card; the other four are plain PyTorch (sorts, a mean, a Gram matrix).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops

Tensor = torch.Tensor


def _rows(updates: Tensor) -> Tensor:
    return updates.reshape(updates.shape[0], -1)


def fedavg(updates: Tensor, weights: Optional[Tensor] = None) -> Tensor:
    """Weighted mean (weights default to uniform; the paper weights by
    |D_i|/|D| — pass data sizes as ``weights``)."""
    g = _rows(updates)
    if weights is None:
        out = torch.mean(g, dim=0)
    else:
        w = weights.to(g.dtype)
        out = (w / torch.clamp(torch.sum(w), min=1e-12)) @ g
    return out.reshape(updates.shape[1:])


def krum(updates: Tensor, n_malicious: int, multi: int = 1) -> Tensor:
    """(Multi-)Krum: score_i = Σ of squared distances to the n−f−2 nearest
    neighbours; the ``multi`` lowest-scoring updates are averaged. The
    distances are ‖a‖² + ‖b‖² − 2ab, as the reference forms them."""
    g = _rows(updates)
    n = g.shape[0]
    sq = torch.sum(g * g, dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (g @ g.T)
    d2 = d2 + torch.eye(n, dtype=g.dtype, device=g.device) * 1e30
    k = max(1, n - n_malicious - 2)
    nearest = torch.topk(d2, k, dim=1, largest=False).values
    scores = torch.sum(nearest, dim=1)
    sel = torch.topk(scores, max(1, multi), largest=False).indices
    return torch.mean(g[sel], dim=0).reshape(updates.shape[1:])


def trimmed_mean(updates: Tensor, trim_frac: float = 0.1) -> Tensor:
    """Coordinate-wise trimmed mean: drop the ``trim`` largest and smallest
    values per coordinate."""
    g = _rows(updates)
    n = g.shape[0]
    trim = int(n * trim_frac)
    s = torch.sort(g, dim=0).values
    kept = s[trim:n - trim] if trim > 0 else s
    return torch.mean(kept, dim=0).reshape(updates.shape[1:])


def coordinate_median(updates: Tensor) -> Tensor:
    """Coordinate-wise median; for an even count the mean of the middle
    pair, as ``jnp.median`` takes it (``torch.median`` returns the lower
    value, and ``torch.quantile`` refuses inputs over 2²⁴ elements)."""
    g = _rows(updates)
    n = g.shape[0]
    s = torch.sort(g, dim=0).values
    lo, hi = s[(n - 1) // 2], s[n // 2]
    return ((lo + hi) * 0.5).reshape(updates.shape[1:])


def fltrust(updates: Tensor, ref_update: Tensor, eps: float = 1e-12
            ) -> Tensor:
    """FLTrust [8]: TS_i = ReLU(cos(g_i, g_ref)); updates rescaled to the
    reference norm; trust-weighted average — one ``weighted_agg`` launch
    without segments on the card."""
    g = _rows(updates)
    ref = ref_update.reshape(-1)
    refn = torch.linalg.vector_norm(ref)
    norms = torch.linalg.vector_norm(g, dim=1)
    cos = (g @ ref) / torch.clamp(norms * refn, min=eps)
    ts = torch.relu(cos)
    out = ops.weighted_agg(g, ts, norms, refn, eps=eps)
    return out.reshape(updates.shape[1:])


AGGREGATORS = {
    "fedavg": lambda u, ctx: fedavg(u, ctx.get("weights")),
    "krum": lambda u, ctx: krum(u, ctx.get("n_malicious", 0),
                                ctx.get("multi", 1)),
    "trimmed_mean": lambda u, ctx: trimmed_mean(u, ctx.get("trim_frac", 0.1)),
    "median": lambda u, ctx: coordinate_median(u),
    "fltrust": lambda u, ctx: fltrust(u, ctx["ref_update"]),
}
