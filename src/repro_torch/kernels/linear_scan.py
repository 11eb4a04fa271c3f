"""Diagonal linear recurrence h_t = a_t ⊙ h_{t-1} + b_t along axis 1: the
Hopper port of ``repro/kernels/linear_scan.py:linear_scan`` (CUDA source
``csrc/linear_scan.cu``), with its plain PyTorch version. Oracle:
``repro/kernels/ref.py:linear_scan_ref``. It carries the state of every
RG-LRU layer's full-sequence forward (``models.rglru.rglru_prefill``).

``linear_scan`` is differentiable (:class:`LinearScan`). Its backward is
itself a linear scan, run in reverse time: for h_t = a_t·h_{t-1} + b_t
the adjoint g_t = ∂h_t + a_{t+1}·g_{t+1} (a_T = 0) gives ∂b_t = g_t and
∂a_t = g_t·h_{t-1} (h_{-1} = 0). :func:`linear_scan_bwd` computes it with
one launch of the same kernel on the time-reversed inputs, counted apart
(``linear_scan_bwd.launches``). The TPU kernel has no backward: the
reference trains through ``jax.lax.associative_scan``
(``repro/models/rglru.py:rglru_scan``).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

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


def _scan(a: Tensor, b: Tensor, counter) -> Tensor:
    """h from a, b: :func:`linear_scan_plain` for CPU tensors, the kernel
    on the current stream for CUDA tensors (or raise), one added to
    ``counter.launches`` per launch."""
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
    counter.launches += 1
    return h


def linear_scan_bwd(a: Tensor, h: Tensor, dh: Tensor
                    ) -> Tuple[Tensor, Tensor]:
    """(∂a, ∂b) of h = linear_scan(a, b) given ∂h, in ``a``'s dtype: the
    reverse scan g_t = ∂h_t + a_{t+1}·g_{t+1} as one forward scan of the
    time-reversed A_s = a_{T-s}, D_s = ∂h_{T-1-s} (A_0 multiplies
    h_{-1} = 0, so any value serves: index 0 is taken, keeping the
    gather one copy), then ∂b = g and ∂a_t = g_t·h_{t-1}. Three
    contiguous copies (the two gathers and the flip back) and one
    product beside the scan. CPU tensors take the plain scan; CUDA
    tensors launch the kernel (one added to this function's
    ``launches``)."""
    t = a.shape[1]
    rev = torch.arange(t - 1, -1, -1, device=a.device)
    g_rev = _scan(a.index_select(1, torch.remainder(rev + 1, t)),
                  dh.to(a.dtype).index_select(1, rev), linear_scan_bwd)
    db = g_rev.flip(1)
    da = torch.empty_like(db)
    da[:, :1] = 0
    torch.mul(db[:, 1:], h[:, :-1], out=da[:, 1:])
    return da, db


linear_scan_bwd.launches = 0


class LinearScan(torch.autograd.Function):
    """h = linear_scan(a, b) with its adjoint :func:`linear_scan_bwd`;
    saves ``a`` and ``h``."""

    @staticmethod
    def forward(ctx, a: Tensor, b: Tensor) -> Tensor:
        h = _scan(a, b, linear_scan)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    @once_differentiable
    def backward(ctx, dh: Tensor) -> Tuple[Tensor, Tensor]:
        a, h = ctx.saved_tensors
        return linear_scan_bwd(a, h, dh)


def linear_scan(a: Tensor, b: Tensor) -> Tensor:
    """h (B, T, D) in ``a``'s dtype from a, b (B, T, D) float32/bfloat16,
    accumulated in fp32, differentiable in a and b. CPU tensors take
    :func:`linear_scan_plain`; CUDA tensors launch the kernel on the
    current stream (or raise)."""
    return LinearScan.apply(a, b)


linear_scan.launches = 0
