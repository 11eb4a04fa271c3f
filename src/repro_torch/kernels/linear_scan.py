"""Diagonal linear recurrence h_t = a_t ⊙ h_{t-1} + b_t along axis 1: the
Hopper port of ``repro/kernels/linear_scan.py:linear_scan`` (CUDA source
``csrc/linear_scan.cu``), with its plain PyTorch version. Oracle:
``repro/kernels/ref.py:linear_scan_ref``. It carries the state of every
RG-LRU layer's full-sequence forward (``models.rglru.rglru_forward``).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_BATCH = 65535          # gridDim.z


def linear_scan_plain(a: Tensor, b: Tensor) -> Tensor:
    """h_t = a_t*h_{t-1} + b_t over axis 1 of (B, T, D), h_{-1} = 0: a
    log-depth (Hillis–Steele) scan in fp32 with ``linear_scan_ref``'s
    combine (a1, b1) ∘ (a2, b2) = (a1·a2, a2·b1 + b2); h in ``a``'s
    dtype. About log2(T) rounds of elementwise products, so a CUDA graph
    of it holds a few dozen launches, not T."""
    A = a.to(torch.float32)
    H = b.to(torch.float32)
    t = a.shape[1]
    s = 1
    while s < t:
        H = torch.cat([H[:, :s], A[:, s:] * H[:, :-s] + H[:, s:]], dim=1)
        if 2 * s < t:
            A = torch.cat([A[:, :s], A[:, s:] * A[:, :-s]], dim=1)
        s *= 2
    return H.to(a.dtype)


def _lib():
    lib = _build.load("linear_scan")
    fn = lib.linear_scan_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def linear_scan(a: Tensor, b: Tensor) -> Tensor:
    """h (B, T, D) in ``a``'s dtype from a, b (B, T, D) float32/bfloat16,
    accumulated in fp32. CPU tensors take :func:`linear_scan_plain`; CUDA
    tensors launch the kernel on the current stream (or raise)."""
    if a.device != b.device:
        raise ValueError(f"linear_scan: a on {a.device}, b on {b.device}")
    if a.device.type == "cpu":
        return linear_scan_plain(a, b)
    if a.dim() != 3 or a.shape != b.shape:
        raise ValueError(f"linear_scan: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must be one (B, T, D) shape")
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise ValueError(f"linear_scan: a {a.dtype} / b {b.dtype}; the "
                         "kernel takes float32 or bfloat16, both alike")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("linear_scan: a and b must be contiguous")
    bsz, t, d = a.shape
    if bsz > _MAX_BATCH:
        raise ValueError(f"linear_scan: batch {bsz} > {_MAX_BATCH}")
    h = torch.empty_like(a)
    err = _lib()(a.data_ptr(), b.data_ptr(), h.data_ptr(), _DTYPES[a.dtype],
                 bsz, t, d, torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(err, "linear_scan")
    linear_scan.launches += 1
    return h


linear_scan.launches = 0
