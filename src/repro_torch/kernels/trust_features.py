"""Fused per-client trust feature pass: the Hopper port of
``repro/kernels/trust_features.py:trust_features``, with its plain
PyTorch version (``repro_torch.core.features.client_features``). On CUDA
tensors it launches the ``features`` mode of the fused trust-stage kernel
(``csrc/trust_stage.cu``, see ``trust_stage``); the round engine runs the
whole stage in one launch of that kernel instead.

Signature is a superset of the TPU kernel's: ``refs`` is either one
reference row per row of G, (M, D) (the TPU kernel's own mode), or a
(K, D) matrix gathered per row through ``ref_idx`` (M,) — the engine's
own-cloud reference, as ``trust_score`` takes it. ``med`` is a 0-d
tensor (it stays on the device: no host sync) and may be NaN or
non-positive; it is sanitized inside, as the TPU kernel does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.features import N_FEATURES, client_features

Tensor = torch.Tensor


def trust_features_plain(grads: Tensor, refs: Tensor, gbar: Tensor,
                         med: Tensor, w: Tensor,
                         ref_idx: Optional[Tensor] = None,
                         eps: float = 1e-12) -> Tensor:
    """(M, 4) float32 features (``client_features`` on gathered refs)."""
    rows = refs if ref_idx is None else refs[ref_idx.long()]
    return client_features(grads, rows, gbar, med, w, eps)


def trust_features(grads: Tensor, refs: Tensor, gbar: Tensor, med: Tensor,
                   w: Tensor, ref_idx: Optional[Tensor] = None,
                   eps: float = 1e-12) -> Tensor:
    """(M, 4) features of G (M, D) f32/bf16, accumulated in f32. CPU
    tensors take :func:`trust_features_plain`; CUDA tensors launch the
    kernel (or raise)."""
    if grads.device.type == "cpu":
        return trust_features_plain(grads, refs, gbar, med, w, ref_idx, eps)
    from repro_torch.kernels import trust_stage as stage
    m, d = grads.shape
    if grads.dtype not in stage.DTYPES or not grads.is_contiguous():
        raise ValueError("trust_features: G must be contiguous "
                         "float32/bfloat16")
    dev = grads.device
    if refs.dtype != grads.dtype or refs.dim() != 2 or refs.shape[1] != d:
        raise ValueError(f"trust_features: refs {tuple(refs.shape)} "
                         f"{refs.dtype} do not fit G {(m, d)} {grads.dtype}")
    refs = refs.to(dev).contiguous()
    gbar = gbar.to(dev, torch.float32).contiguous()
    med = torch.as_tensor(med).to(dev, torch.float32).reshape(1)
    w = w.to(dev, torch.float32).contiguous()
    if gbar.shape != (d,) or w.shape != (m,):
        raise ValueError(f"trust_features: gbar {tuple(gbar.shape)} / w "
                         f"{tuple(w.shape)} do not fit G {(m, d)}")
    if ref_idx is None:
        if refs.shape[0] != m:
            raise ValueError("trust_features: per-row mode takes refs (M, D)")
        ref_mode = stage.REF_ROWS
    else:
        if ref_idx.shape != (m,):
            raise ValueError("trust_features: cloud mode takes ref_idx (M,)")
        ref_idx = ref_idx.to(dev, torch.int64).contiguous()
        ref_mode = stage.REF_INDEXED
    out = torch.empty(m, N_FEATURES, dtype=torch.float32, device=dev)
    stage.launch(stage.MODE_FEATURES, grads, d, refs, d, ref_mode,
                 refs.shape[0], 0, d, m,
                 (None,) * 6 + (out.data_ptr(),) + (None,) * 3,
                 ref_idx=ref_idx, w=w, gbar_in=gbar, med_in=med, eps=eps)
    trust_features.launches += 1
    return out


trust_features.launches = 0
