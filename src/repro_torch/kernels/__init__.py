"""Hand-written Hopper (sm_90a) CUDA kernels for the port's hot path,
each beside its plain PyTorch version:

* ``trust_stage``  — the round's whole trust stage in one launch: Eq. 7
  with the median damp, the multi-feature gate, Eq. 8–9 and Eq. 11
  (replaces the Pallas ``trust_score`` and ``trust_features`` below,
  fused with the tensor code around them);
* ``trust_score``  — Eq. 7 + 11 statistics (replaces the Pallas
  ``repro/kernels/trust_score.py:trust_score``; the ``score`` mode of
  ``trust_stage``'s kernel);
* ``weighted_agg`` — Eq. 12 + 13 per-cloud aggregation (replaces
  ``repro/kernels/weighted_agg.py:weighted_agg``);
* ``topk_mask``    — top-k sparsification mask (replaces
  ``repro/kernels/topk_mask.py:topk_mask``);
* ``stochastic_quantize`` — QSGD stochastic rounding, with the codec's
  dequantize and error-feedback residual fused (replaces
  ``repro/kernels/quantize.py:stochastic_quantize``);
* ``trust_features`` — the multi-feature trust pass (replaces
  ``repro/kernels/trust_features.py:trust_features``; the ``features``
  mode of ``trust_stage``'s kernel);
* ``linear_scan`` — the RG-LRU diagonal recurrence (replaces
  ``repro/kernels/linear_scan.py:linear_scan``).

A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches its kernel (built by ``_build`` at first use) or raises, and
adds one to its ``launches`` counter per launch. ``ops`` gathers them.
"""
from repro_torch.kernels import ops

__all__ = ["ops"]
