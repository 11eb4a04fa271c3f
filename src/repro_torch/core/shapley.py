"""Shapley-value contribution evaluation (paper §IV-B, Fig. 5).

* ``gradient_contribution`` — the paper's O(N) lightweight score (Eq. 7).
  The round engine and the host twin compute it inside the fused
  ``trust_stage`` kernel (``trust_score`` is that kernel's standalone
  mode); this is the plain form.
* ``exact_shapley`` — O(2^N) enumeration for ground truth on tiny N.
* ``monte_carlo_shapley`` — permutation-sampling baseline (Data Shapley).

The latter two, and ``cosine_utility``, are numpy float64 validation
tools (Fig. 5's time and Pearson correlation), copies of the reference's
``repro/core/shapley.py``, not device code.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
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


def exact_shapley(utility: Callable[[np.ndarray], float], n: int
                  ) -> np.ndarray:
    """Exact Shapley values by subset enumeration. ``utility`` maps a
    boolean mask (n,) -> scalar coalition utility. O(2^n) — tiny n only."""
    if n > 16:
        raise ValueError("exact enumeration is exponential; use n <= 16")
    phi = np.zeros(n)
    fact = math.factorial
    denom = fact(n)
    util = {}
    for bits in range(1 << n):
        mask = np.array([(bits >> j) & 1 for j in range(n)], bool)
        util[bits] = float(utility(mask))
    for i in range(n):
        for bits in range(1 << n):
            if (bits >> i) & 1:
                continue
            s = bin(bits).count("1")
            w = fact(s) * fact(n - s - 1) / denom
            phi[i] += w * (util[bits | (1 << i)] - util[bits])
    return phi


def monte_carlo_shapley(utility: Callable[[np.ndarray], float], n: int,
                        n_perms: int = 200, seed: int = 0) -> np.ndarray:
    """Permutation-sampling Shapley (Ghorbani & Zou 2019), permutations
    from ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    phi = np.zeros(n)
    for _ in range(n_perms):
        perm = rng.permutation(n)
        mask = np.zeros(n, bool)
        prev = float(utility(mask))
        for i in perm:
            mask[i] = True
            cur = float(utility(mask))
            phi[i] += cur - prev
            prev = cur
    return phi / n_perms


def cosine_utility(last_layer_grads: np.ndarray, reference: np.ndarray
                   ) -> Callable[[np.ndarray], float]:
    """Coalition utility used for validation: alignment of the
    coalition's mean gradient with a reference direction (a proxy for the
    coalition's marginal loss improvement under one SGD step)."""
    g = np.asarray(last_layer_grads, np.float64).reshape(
        last_layer_grads.shape[0], -1)
    ref = np.asarray(reference, np.float64).reshape(-1)
    refn = np.linalg.norm(ref) + 1e-12

    def utility(mask: np.ndarray) -> float:
        if not mask.any():
            return 0.0
        gm = g[mask].mean(axis=0)
        return float(gm @ ref) / refn
    return utility
