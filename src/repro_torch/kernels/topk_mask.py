"""Top-k threshold mask for gradient sparsification: the Hopper port of
``repro/kernels/topk_mask.py:topk_mask`` (CUDA source
``csrc/topk_mask.cu``), with its plain PyTorch version.

The threshold (the k-th largest |g| of each row) stays outside the
kernel — :func:`row_threshold`, as ``lax.top_k`` sits outside the Pallas
body in ``repro/kernels/ops.py:63``. Rows past ``thr``'s length take
thr = +inf (all zero), the TPU kernel's padded-row semantics.
``fp16_roundtrip=True`` also rounds the kept values through fp16 — the
top-k codec's wire precision — in the same pass; without it the function
equals ``topk_mask_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def row_threshold(grads: Tensor, k: int) -> Tensor:
    """(N,) k-th largest |g| of each row (in ``grads``' dtype)."""
    return torch.topk(grads.abs(), k, dim=1).values[:, -1]


def topk_mask_plain(grads: Tensor, thr: Tensor,
                    fp16_roundtrip: bool = False) -> Tensor:
    """Zero every |G[i, d]| < thr[i] (ties kept); optional fp16 round
    trip of the kept values."""
    n = grads.shape[0]
    t = torch.full((n,), float("inf"), dtype=grads.dtype, device=grads.device)
    t[:thr.shape[0]] = thr.to(grads.dtype)
    out = torch.where(grads.abs() >= t[:, None], grads,
                      torch.zeros((), dtype=grads.dtype, device=grads.device))
    if fp16_roundtrip:
        out = out.to(torch.float16).to(grads.dtype)
    return out


def _lib():
    lib = _build.load("topk_mask")
    fn = lib.topk_mask_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_int, p, p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def topk_mask(grads: Tensor, thr: Tensor,
              fp16_roundtrip: bool = False) -> Tensor:
    """Masked copy of G (N, D). CPU tensors take :func:`topk_mask_plain`;
    CUDA tensors launch the kernel (or raise)."""
    if grads.device.type == "cpu":
        return topk_mask_plain(grads, thr, fp16_roundtrip)
    n, d = grads.shape
    if grads.dtype not in _DTYPES or not grads.is_contiguous():
        raise ValueError("topk_mask: G must be contiguous float32/bfloat16")
    if fp16_roundtrip and grads.dtype != torch.float32:
        raise ValueError("topk_mask: fp16_roundtrip takes float32 G")
    if thr.dim() != 1 or thr.shape[0] > n:
        raise ValueError(f"topk_mask: thr {tuple(thr.shape)} for {n} rows")
    # compare in G's dtype, as the TPU kernel does (thr cast to G.dtype)
    t = thr.to(grads.dtype).to(grads.device, torch.float32).contiguous()
    out = torch.empty_like(grads)
    err = _lib()(grads.data_ptr(), _DTYPES[grads.dtype], t.data_ptr(),
                 out.data_ptr(), n, d, t.shape[0], int(fp16_roundtrip),
                 torch.cuda.current_stream(grads.device).cuda_stream)
    _build.check(err, "topk_mask")
    topk_mask.launches += 1
    return out


topk_mask.launches = 0
