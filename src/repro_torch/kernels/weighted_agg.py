"""Fused trust-weighted aggregation (Eq. 12 + Eq. 13): the Hopper port of
``repro/kernels/weighted_agg.py:weighted_agg`` (CUDA source
``csrc/weighted_agg.cu``), with its plain PyTorch version.

Signature is a superset of the TPU kernel's: rows may carry a segment id
``seg`` (m,) in ``[0, n_seg)`` with one ``ref_norm`` per segment, giving
the engine's per-cloud aggregates (``repro/federated/engine.py:757-764``)
in one pass. Without ``seg`` it is exactly ``weighted_agg_ref``:

    out = Σ_i TS_i·(‖g_ref‖/‖g_i‖)·g_i / Σ_i TS_i
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def agg_weights(ts: Tensor, norms: Tensor, ref_norm: Tensor,
                seg: Optional[Tensor], n_seg: int, eps: float = 1e-12
                ) -> Tensor:
    """(m,) float32 row weights TS_i·(‖ref_seg‖/‖g_i‖) / max(Σ_seg TS, eps)
    — formed outside the kernel, as the TPU wrapper forms them."""
    ts = ts.to(torch.float32)
    ref_norm = torch.as_tensor(ref_norm, dtype=torch.float32,
                               device=ts.device).reshape(-1)
    scale = ts / torch.clamp(norms.to(torch.float32), min=eps)
    if seg is None:
        return scale * ref_norm[0] / torch.clamp(torch.sum(ts), min=eps)
    seg = seg.long()
    ts_seg = torch.zeros(n_seg, dtype=torch.float32,
                         device=ts.device).index_add_(0, seg, ts)
    return scale * ref_norm[seg] / torch.clamp(ts_seg, min=eps)[seg]


def weighted_agg_rows_plain(grads: Tensor, w: Tensor,
                            seg: Optional[Tensor] = None,
                            n_seg: int = 1) -> Tensor:
    """out[k] = Σ_{seg_i = k} w_i·G_i, (n_seg, D) float32."""
    g = grads.to(torch.float32)
    if seg is None:
        seg = torch.zeros(g.shape[0], dtype=torch.long, device=g.device)
    out = torch.zeros(n_seg, g.shape[1], dtype=torch.float32, device=g.device)
    return out.index_add_(0, seg.long(), g * w.to(torch.float32)[:, None])


def _lib():
    lib = _build.load("weighted_agg")
    fn = lib.weighted_agg_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_int, p, p, p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int, p]
        fn.restype = ctypes.c_int
        lib.weighted_agg_max_segments.restype = ctypes.c_int
    return lib


def weighted_agg_rows(grads: Tensor, w: Tensor, seg: Optional[Tensor] = None,
                      n_seg: int = 1) -> Tensor:
    """The kernel's own contract: per-segment weighted row sums of G
    (m, D) f32/bf16 with precomputed weights. CPU tensors take
    :func:`weighted_agg_rows_plain`; CUDA tensors launch the kernel (or
    raise)."""
    if grads.device.type == "cpu":
        return weighted_agg_rows_plain(grads, w, seg, n_seg)
    m, d = grads.shape
    if grads.dtype not in _DTYPES or not grads.is_contiguous():
        raise ValueError("weighted_agg: G must be contiguous "
                         "float32/bfloat16")
    lib = _lib()
    if not 1 <= n_seg <= lib.weighted_agg_max_segments():
        raise ValueError(f"weighted_agg: n_seg={n_seg} outside [1, "
                         f"{lib.weighted_agg_max_segments()}]")
    dev = grads.device
    w = w.to(dev, torch.float32).contiguous()
    if w.shape != (m,):
        raise ValueError(f"weighted_agg: w {tuple(w.shape)} != ({m},)")
    seg_ptr = None
    if seg is not None:
        if seg.shape != (m,):
            raise ValueError(f"weighted_agg: seg {tuple(seg.shape)} != ({m},)")
        seg = seg.to(dev, torch.int32).contiguous()
        seg_ptr = seg.data_ptr()
    out = torch.empty(n_seg, d, dtype=torch.float32, device=dev)
    err = lib.weighted_agg_launch(
        grads.data_ptr(), _DTYPES[grads.dtype], w.data_ptr(), seg_ptr,
        out.data_ptr(), m, d, n_seg,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "weighted_agg")
    weighted_agg.launches += 1
    return out


def weighted_agg(grads: Tensor, ts: Tensor, norms: Tensor, ref_norm: Tensor,
                 seg: Optional[Tensor] = None, n_seg: int = 1,
                 eps: float = 1e-12) -> Tensor:
    """Eq. 12 + 13: (D,) without ``seg`` (the TPU kernel's function), else
    the (n_seg, D) per-segment aggregates with ``ref_norm`` (n_seg,)."""
    w = agg_weights(ts, norms, ref_norm, seg, n_seg, eps)
    out = weighted_agg_rows(grads, w, seg, n_seg)
    return out[0] if seg is None else out


def weighted_agg_plain(grads: Tensor, ts: Tensor, norms: Tensor,
                       ref_norm: Tensor, seg: Optional[Tensor] = None,
                       n_seg: int = 1, eps: float = 1e-12) -> Tensor:
    """Plain PyTorch version of :func:`weighted_agg` on any device."""
    w = agg_weights(ts, norms, ref_norm, seg, n_seg, eps)
    out = weighted_agg_rows_plain(grads, w, seg, n_seg)
    return out[0] if seg is None else out


weighted_agg.launches = 0
