"""Cost-TrustFL hierarchical aggregation (Algorithm 1, lines 3–17) on
explicit (N, D) update matrices: the host twin of the round engine's
hierarchical update, which the host round loop runs (the port of
``repro/core/aggregation.py``).

Eq. 7 with the median damp, the multi-feature gate, Eq. 8–9 and Eq. 11
are one launch of the fused ``trust_stage`` kernel over the selected
rows' last layer; Eq. 12–13 per cloud are one segmented ``weighted_agg``
launch over the selected rows; the edge→global wire
(``cloud_transform``), the zero-trust fallback and the Eq. 6 β combine
follow in plain tensor code. Rows that were not selected add exactly
zero to every sum of the reference, so the m-row sums are its sums.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from repro_torch.core import features as feats_mod
from repro_torch.core.reputation import ReputationState
from repro_torch.core.trust import cloud_trust
from repro_torch.kernels import ops

Tensor = torch.Tensor


class AggregationResult(NamedTuple):
    update: Tensor           # (D,) global update (Eq. 6 inner sum)
    reputation: ReputationState
    trust: Tensor            # (N,) TS_i
    phi: Tensor              # (N,) contribution scores (damped, gated)
    beta: Tensor             # (K,) cloud trust
    features: Optional[Tensor] = None      # (N, F) multi-feature matrix
    feat_sep: Optional[Tensor] = None      # (F,) updated separability EMA
    feat_weights: Optional[Tensor] = None  # (F,) softmax mixing weights


def cost_trustfl_aggregate(
    updates: Tensor,                # (N, D) client updates, 0 where not selected
    last_layer: Tensor,             # (N, L) last-layer slices (Eq. 7 input)
    ref_updates: Tensor,            # (K, D) per-cloud reference updates
    ref_last_layer: Tensor,         # (K, L)
    cloud_of: Tensor,               # (N,) int cloud assignment
    selected: Tensor,               # (N,) bool participation mask
    rep_state: ReputationState,
    *,
    gamma: float = 0.9,
    eps: float = 1e-12,
    cloud_transform: Optional[Callable[[Tensor], Tensor]] = None,
    trust_features: str = "scalar",
    feat_sep: Optional[Tensor] = None,
) -> AggregationResult:
    """Eq. 5–13 with a two-level (intra-cloud, cross-cloud) hierarchy;
    clients that were not selected keep their reputation and get φ = TS =
    0. ``cloud_transform`` models the edge→global wire: it maps the (K, D)
    cloud aggregates before the receiver-side zero-trust fallback, which
    puts each cloud's clean reference in place of an aggregate whose
    trust sums to ≤ eps."""
    if trust_features not in ("scalar", "multi"):
        raise ValueError(f"unknown trust_features {trust_features!r}; "
                         "use 'scalar' or 'multi'")
    n = updates.shape[0]
    k = ref_updates.shape[0]
    dev = updates.device
    f32 = torch.float32
    sep_prev = None
    if trust_features == "multi":
        sep_prev = (torch.zeros(feats_mod.N_FEATURES, dtype=f32, device=dev)
                    if feat_sep is None
                    else torch.as_tensor(feat_sep, dtype=f32, device=dev))
    cloud_of = torch.as_tensor(cloud_of, device=dev).long()
    sel_idx = torch.nonzero(torch.as_tensor(selected, device=dev)
                            ).reshape(-1)                       # ascending
    m = sel_idx.numel()
    zeros = torch.zeros(n, dtype=updates.dtype, device=dev)
    global_ref = torch.mean(ref_updates, dim=0)

    if m == 0:
        # trust_stage takes no empty round. The reference's result: φ and
        # TS all 0, reputation unchanged, every cloud on its reference
        # (what cloud_transform would send is discarded by the fallback)
        features = new_sep = feat_w = None
        if sep_prev is not None:
            features = torch.zeros(n, feats_mod.N_FEATURES, dtype=f32,
                                   device=dev)
            new_sep = (feats_mod.FEAT_SEP_RHO * sep_prev
                       + (1.0 - feats_mod.FEAT_SEP_RHO)
                       * feats_mod.separability(features, zeros, eps))
            feat_w = feats_mod.feature_weights(new_sep)
        beta = cloud_trust(ref_updates, global_ref, eps)
        return AggregationResult(beta @ ref_updates, rep_state, zeros,
                                 zeros.clone(), beta, features, new_sep,
                                 feat_w)

    # Eq. 7 (median damp), the gate, Eq. 8–9 and Eq. 11 in one launch
    # over the selected rows' last layer, read whole (lo = 0)
    cloud_sel = cloud_of[sel_idx]
    stage = ops.trust_stage(
        last_layer[sel_idx].to(f32).contiguous(),
        ref_last_layer.to(f32).contiguous(), 0, last_layer.shape[1],
        cloud_sel, torch.ones(m, dtype=f32, device=dev), rep_state.ema,
        sel_idx, gamma, n, feat_sep=sep_prev, eps=eps)
    ema = rep_state.ema.clone()
    ema[sel_idx] = stage.rep_sel
    phi = zeros.index_copy(0, sel_idx, stage.phi)
    ts = zeros.index_copy(0, sel_idx, stage.ts)
    features = None
    if sep_prev is not None:
        features = torch.zeros(n, feats_mod.N_FEATURES, dtype=f32,
                               device=dev).index_copy(0, sel_idx, stage.feats)

    # Eq. 12 rescale to the own-cloud reference norm + Eq. 13 per cloud
    g = updates[sel_idx]
    cloud_aggs = ops.weighted_agg(
        g, stage.ts, torch.linalg.vector_norm(g, dim=1),
        torch.linalg.vector_norm(ref_updates, dim=1), seg=cloud_sel,
        n_seg=k, eps=eps)
    ts_cloud = torch.zeros(k, dtype=f32, device=dev).index_add_(
        0, cloud_sel, stage.ts)
    if cloud_transform is not None:
        cloud_aggs = cloud_transform(cloud_aggs)
    cloud_aggs = torch.where((ts_cloud > eps)[:, None], cloud_aggs,
                             ref_updates)

    # Eq. 6 cross-cloud combine against the global reference direction
    beta = cloud_trust(cloud_aggs, global_ref, eps)
    return AggregationResult(beta @ cloud_aggs, ReputationState(ema=ema), ts,
                             phi, beta, features, stage.new_sep,
                             stage.feat_w)
