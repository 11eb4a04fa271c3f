"""Public wrappers of the port's kernels (the counterpart of
``repro/kernels/ops.py``), plus the launch-count registry a run reads to
show that its main path went through the kernels."""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels.linear_scan import linear_scan, linear_scan_plain
from repro_torch.kernels.stochastic_quantize import (
    quantize_roundtrip, quantize_roundtrip_plain, stochastic_quantize,
    stochastic_quantize_plain)
from repro_torch.kernels.topk_mask import (row_threshold, topk_mask,
                                           topk_mask_plain)
from repro_torch.kernels.trust_features import (trust_features,
                                                trust_features_plain)
from repro_torch.kernels.trust_score import trust_score, trust_score_plain
from repro_torch.kernels.trust_stage import (TrustStage, trust_stage,
                                             trust_stage_plain)
from repro_torch.kernels.weighted_agg import (agg_weights, weighted_agg,
                                              weighted_agg_plain,
                                              weighted_agg_rows,
                                              weighted_agg_rows_plain)

# one counter per wrapper that launches a kernel (quantize_roundtrip
# launches stochastic_quantize's; trust_score and trust_features launch
# the standalone modes of trust_stage's kernel, counted apart)
KERNELS = {"trust_stage": trust_stage, "trust_score": trust_score,
           "weighted_agg": weighted_agg, "topk_mask": topk_mask,
           "stochastic_quantize": stochastic_quantize,
           "trust_features": trust_features, "linear_scan": linear_scan}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = ["trust_stage", "trust_stage_plain", "TrustStage",
           "trust_score", "trust_score_plain", "weighted_agg",
           "weighted_agg_plain", "weighted_agg_rows",
           "weighted_agg_rows_plain", "agg_weights", "topk_mask",
           "topk_mask_plain", "row_threshold", "stochastic_quantize",
           "stochastic_quantize_plain", "quantize_roundtrip",
           "quantize_roundtrip_plain", "trust_features",
           "trust_features_plain", "linear_scan", "linear_scan_plain",
           "KERNELS", "reset_launch_counts",
           "launch_counts"]
