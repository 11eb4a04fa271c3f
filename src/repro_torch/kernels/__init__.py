"""Hand-written Hopper (sm_90a) CUDA kernels for the port's hot path,
each beside its plain PyTorch version:

* ``trust_score``  — Eq. 7 + 11 statistics (replaces the Pallas
  ``repro/kernels/trust_score.py:trust_score``);
* ``weighted_agg`` — Eq. 12 + 13 per-cloud aggregation (replaces
  ``repro/kernels/weighted_agg.py:weighted_agg``);
* ``topk_mask``    — top-k sparsification mask (replaces
  ``repro/kernels/topk_mask.py:topk_mask``).

A wrapper given CPU tensors runs the plain version; given CUDA tensors
it launches its kernel (built by ``_build`` at first use) or raises, and
adds one to its ``launches`` counter per launch. ``ops`` gathers them.
"""
from repro_torch.kernels import ops

__all__ = ["ops"]
