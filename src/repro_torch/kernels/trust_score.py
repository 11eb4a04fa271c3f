"""Fused per-client trust statistics (Eq. 7 + Eq. 11): the Hopper port of
``repro/kernels/trust_score.py:trust_score``, with its plain PyTorch
version. On CUDA tensors it launches the ``score`` mode of the fused
trust-stage kernel (``csrc/trust_stage.cu``, see ``trust_stage``); the
round engine runs the whole stage in one launch of that kernel instead.

Signature is a superset of the TPU kernel's: ``ref`` is either one
``(L,)`` reference (the TPU kernel's own mode) or a ``(K, L)`` matrix
gathered per row through ``ref_idx`` ``(m,)`` — the engine's own-cloud
reference (``repro/federated/engine.py:715``). ``gbar`` is an input,
computed outside as the TPU wrapper computes it outside its body.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def trust_score_plain(grads: Tensor, gbar: Tensor, ref: Tensor,
                      reputation: Tensor, ref_idx: Optional[Tensor] = None,
                      eps: float = 1e-12) -> Tuple[Tensor, Tensor, Tensor]:
    """(phi, ts, norms), each (m,) float32:
    phi = ReLU(cos(g, gbar))·‖g‖, ts = ReLU(cos(g, ref_row))·rep, ‖g‖."""
    g = grads.to(torch.float32)
    b = gbar.to(torch.float32).reshape(-1)
    r = ref.to(torch.float32)
    r = r.reshape(1, -1).expand(g.shape[0], -1) if ref_idx is None \
        else r[ref_idx.long()]
    norms = torch.sqrt(torch.clamp(torch.sum(g * g, dim=1), min=0.0))
    nbar = torch.sqrt(torch.clamp(torch.sum(b * b), min=0.0))
    nref = torch.sqrt(torch.clamp(torch.sum(r * r, dim=1), min=0.0))
    cos_bar = (g @ b) / torch.clamp(norms * nbar, min=eps)
    cos_ref = torch.sum(g * r, dim=1) / torch.clamp(norms * nref, min=eps)
    phi = torch.clamp(cos_bar, min=0.0) * norms
    ts = torch.clamp(cos_ref, min=0.0) * reputation.to(torch.float32)
    return phi, ts, norms


def trust_score(grads: Tensor, gbar: Tensor, ref: Tensor, reputation: Tensor,
                ref_idx: Optional[Tensor] = None, eps: float = 1e-12
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """Fused (phi, ts, norms) over G (m, L) f32/bf16; accumulates in f32.
    CPU tensors take :func:`trust_score_plain`; CUDA tensors launch the
    kernel (or raise)."""
    if grads.device.type == "cpu":
        return trust_score_plain(grads, gbar, ref, reputation, ref_idx, eps)
    from repro_torch.kernels import trust_stage as stage
    m, L = grads.shape
    if grads.dtype not in stage.DTYPES or not grads.is_contiguous():
        raise ValueError("trust_score: G must be contiguous float32/bfloat16")
    dev = grads.device
    gbar = gbar.to(dev, torch.float32).contiguous()
    ref = ref.to(dev, torch.float32).contiguous()
    rep = reputation.to(dev, torch.float32).contiguous()
    if gbar.shape != (L,) or rep.shape != (m,):
        raise ValueError(f"trust_score: gbar {tuple(gbar.shape)} / rep "
                         f"{tuple(rep.shape)} do not fit G {(m, L)}")
    if ref_idx is None:
        if ref.shape != (L,):
            raise ValueError("trust_score: single-ref mode takes ref (L,)")
        ref_mode, n_ref = stage.REF_SINGLE, 1
    else:
        if ref.dim() != 2 or ref.shape[1] != L or ref_idx.shape != (m,):
            raise ValueError("trust_score: cloud mode takes ref (K, L) and "
                             "ref_idx (m,)")
        ref_idx = ref_idx.to(dev, torch.int64).contiguous()
        ref_mode, n_ref = stage.REF_INDEXED, ref.shape[0]
    out = torch.empty(3, m, dtype=torch.float32, device=dev)
    phi, ts, norms = out.unbind(0)
    stage.launch(stage.MODE_SCORE, grads, L, ref, L, ref_mode, n_ref, 0, L,
                 m, (phi.data_ptr(), ts.data_ptr(), norms.data_ptr())
                 + (None,) * 7, ref_idx=ref_idx, gbar_in=gbar, rep=rep,
                 eps=eps)
    trust_score.launches += 1
    return phi, ts, norms


trust_score.launches = 0
