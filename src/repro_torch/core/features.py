"""Multi-feature trust scoring (the port of ``repro/core/features.py``).

Four per-client features of the delivered (m, L) last-layer matrix, all
in [0, 1] and zero on rows with w = 0:

  f0 norm_profile    1 / (1 + |log(‖g_i‖ / med)|), med the selected
                     median norm;
  f1 ref_cosine      ReLU(cos(g_i, ref_k(i))), the own-cloud reference;
  f2 sign_agreement  fraction of coordinates with g_id·ḡ_d > 0;
  f3 loss_delta      x / (1 + x), x = f1·min(‖g_i‖/med, med/‖g_i‖).

Per-feature separability is the positive part of the weighted Pearson
correlation of each feature with the ref-cosine anchor (the one signal
clients cannot poison), EMA-tracked across rounds (``FEAT_SEP_RHO``),
softmax-mixed (temperature ``WEIGHT_TEMP``) and applied as the capped
gate φ·(1 − β + β·F@w) with β = ``BETA_MAX``·sep[norm_profile]: with no
evidence the gate is 1 and ``multi`` equals ``scalar``.
:func:`client_features` is the plain version of the ``trust_features``
kernel (``repro_torch.kernels.trust_features``, a mode of the fused
``trust_stage`` kernel that the round engine launches once a round).
"""
from __future__ import annotations

import torch

Tensor = torch.Tensor

N_FEATURES = 4
FEATURE_NAMES = ("norm_profile", "ref_cosine", "sign_agreement",
                 "loss_delta")
FEAT_SEP_RHO = 0.5      # EMA factor for per-feature separability
WEIGHT_TEMP = 0.2       # softmax temperature over separability ∈ [0,1]
ANCHOR_FEATURE = 1      # ref_cosine: the unpoisonable supervision anchor
CONSENSUS_FEATURE = 0   # norm_profile: the direction-independent witness
BETA_MAX = 0.3          # cap on the gate's multiplicative range


def client_features(last_layer: Tensor, ref_rows: Tensor, gbar: Tensor,
                    med: Tensor, w: Tensor, eps: float = 1e-12) -> Tensor:
    """(m, N_FEATURES) float32 features of the rows of ``last_layer``
    (m, L) against their own reference rows ``ref_rows`` (m, L)."""
    g = last_layer.to(torch.float32)
    r = ref_rows.to(torch.float32)
    # NaN or non-positive med (no delivered row) -> 1
    med = torch.as_tensor(med, dtype=torch.float32, device=g.device)
    med = torch.where(torch.isnan(med) | ~(med > 0), torch.ones_like(med),
                      med)

    norms = torch.linalg.vector_norm(g, dim=1)
    ref_norms = torch.linalg.vector_norm(r, dim=1)
    dots = torch.sum(g * r, dim=1)

    f0 = 1.0 / (1.0 + torch.abs(torch.log(torch.clamp(norms, min=eps)
                                          / med)))
    f1 = torch.relu(dots / torch.clamp(norms * ref_norms, min=eps))
    # the count over an IEEE division by a tensor (a division by a Python
    # scalar may run as a product with its reciprocal on the card)
    f2 = (torch.sum((g * gbar.to(torch.float32)[None, :] > 0)
                    .to(torch.float32), dim=1)
          / torch.full((), float(g.shape[1]), device=g.device))
    ratio = torch.clamp(norms, min=eps) / med
    x = f1 * torch.minimum(ratio, 1.0 / ratio)
    f3 = x / (1.0 + x)
    feats = torch.stack([f0, f1, f2, f3], dim=1)
    return feats * w.to(torch.float32)[:, None]


def separability_sums(feats: Tensor, w: Tensor) -> Tensor:
    """(6, F) weighted sums [Σw, Σw·f, Σw·a, Σw·f², Σw·a², Σw·f·a] of a
    Pearson correlation against the anchor column a."""
    wv = w.to(torch.float32)[:, None]
    f = feats.to(torch.float32)
    r = f[:, ANCHOR_FEATURE][:, None]
    ones = torch.ones_like(f)
    return torch.stack([
        torch.sum(wv * ones, dim=0),
        torch.sum(wv * f, dim=0),
        torch.sum(wv * r * ones, dim=0),
        torch.sum(wv * f * f, dim=0),
        torch.sum(wv * r * r * ones, dim=0),
        torch.sum(wv * f * r, dim=0),
    ], dim=0)


def separability_from_sums(sums: Tensor, eps: float = 1e-12) -> Tensor:
    """ReLU(weighted Pearson corr(feature, anchor)) per feature, (F,);
    0 for degenerate rounds (no delivery, or zero variance)."""
    sw = torch.clamp(sums[0], min=eps)
    mean_f = sums[1] / sw
    mean_r = sums[2] / sw
    var_f = torch.clamp(sums[3] / sw - mean_f ** 2, min=0.0)
    var_r = torch.clamp(sums[4] / sw - mean_r ** 2, min=0.0)
    cov = sums[5] / sw - mean_f * mean_r
    corr = cov / torch.sqrt(torch.clamp(var_f * var_r, min=eps * eps))
    corr = torch.where((var_f > eps) & (var_r > eps), corr,
                       torch.zeros_like(corr))
    return torch.clamp(corr, 0.0, 1.0)


def separability(feats: Tensor, w: Tensor, eps: float = 1e-12) -> Tensor:
    """(F,) separability of this round."""
    return separability_from_sums(separability_sums(feats, w), eps)


def feature_weights(feat_sep: Tensor) -> Tensor:
    """Softmax mixing weights (uniform with no evidence)."""
    return torch.softmax(feat_sep.to(torch.float32) / WEIGHT_TEMP, dim=0)


def gate_strength(feat_sep: Tensor) -> Tensor:
    """β = BETA_MAX · clip(sep[norm_profile], 0, 1): confidence needs the
    norm modality to corroborate the direction anchor."""
    sep0 = feat_sep.to(torch.float32)[CONSENSUS_FEATURE]
    return BETA_MAX * torch.clamp(sep0, 0.0, 1.0)


def gate(feats: Tensor, feat_sep: Tensor) -> Tensor:
    """The (m,) multiplicative trust gate 1 − β + β·(F @ weights)."""
    beta = gate_strength(feat_sep)
    return 1.0 - beta + beta * (feats @ feature_weights(feat_sep))
