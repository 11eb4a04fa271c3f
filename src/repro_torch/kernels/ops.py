"""Public wrappers of the port's kernels (the counterpart of
``repro/kernels/ops.py``), plus the launch-count registry a run reads to
show that its main path went through the kernels."""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels.topk_mask import (row_threshold, topk_mask,
                                           topk_mask_plain)
from repro_torch.kernels.trust_score import trust_score, trust_score_plain
from repro_torch.kernels.weighted_agg import (agg_weights, weighted_agg,
                                              weighted_agg_plain,
                                              weighted_agg_rows,
                                              weighted_agg_rows_plain)

KERNELS = {"trust_score": trust_score, "weighted_agg": weighted_agg,
           "topk_mask": topk_mask}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


__all__ = ["trust_score", "trust_score_plain", "weighted_agg",
           "weighted_agg_plain", "weighted_agg_rows",
           "weighted_agg_rows_plain", "agg_weights", "topk_mask",
           "topk_mask_plain", "row_threshold", "KERNELS",
           "reset_launch_counts", "launch_counts"]
