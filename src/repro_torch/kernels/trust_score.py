"""Fused per-client trust statistics (Eq. 7 + Eq. 11): the Hopper port of
``repro/kernels/trust_score.py:trust_score`` (CUDA source
``csrc/trust_score.cu``), with its plain PyTorch version.

Signature is a superset of the TPU kernel's: ``ref`` is either one
``(L,)`` reference (the TPU kernel's own mode) or a ``(K, L)`` matrix
gathered per row through ``ref_idx`` ``(m,)`` — the engine's own-cloud
reference (``repro/federated/engine.py:715``). ``gbar`` is an input,
computed outside as the TPU wrapper computes it outside its body.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def _lib():
    lib = _build.load("trust_score")
    fn = lib.trust_score_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_int, p, p, p, p, p, p, p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def trust_score(grads: Tensor, gbar: Tensor, ref: Tensor, reputation: Tensor,
                ref_idx: Optional[Tensor] = None, eps: float = 1e-12
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """Fused (phi, ts, norms) over G (m, L) f32/bf16; accumulates in f32.
    CPU tensors take :func:`trust_score_plain`; CUDA tensors launch the
    kernel (or raise)."""
    if grads.device.type == "cpu":
        return trust_score_plain(grads, gbar, ref, reputation, ref_idx, eps)
    m, L = grads.shape
    if grads.dtype not in _DTYPES or not grads.is_contiguous():
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
        idx_ptr = None
    else:
        if ref.dim() != 2 or ref.shape[1] != L or ref_idx.shape != (m,):
            raise ValueError("trust_score: cloud mode takes ref (K, L) and "
                             "ref_idx (m,)")
        ref_idx = ref_idx.to(dev, torch.int32).contiguous()
        idx_ptr = ref_idx.data_ptr()
    phi = torch.empty(m, dtype=torch.float32, device=dev)
    ts = torch.empty_like(phi)
    norms = torch.empty_like(phi)
    err = _lib()(grads.data_ptr(), _DTYPES[grads.dtype], gbar.data_ptr(),
                 ref.data_ptr(), idx_ptr, rep.data_ptr(), phi.data_ptr(),
                 ts.data_ptr(), norms.data_ptr(), m, L, eps,
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "trust_score")
    trust_score.launches += 1
    return phi, ts, norms


trust_score.launches = 0
