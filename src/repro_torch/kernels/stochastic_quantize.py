"""QSGD stochastic-rounding quantization: the Hopper port of
``repro/kernels/quantize.py:stochastic_quantize`` (CUDA source
``csrc/stochastic_quantize.cu``), with its plain PyTorch version.

Two modes over x (N, D) with per-row scales s (N,) and uniform noise
u (N, D) in [0, 1):

* :func:`stochastic_quantize` — the TPU kernel's function, int32 levels
  q = sign(v)·min(⌊|v| + u⌋, L) with v = x / max(s, ε) · L;
* :func:`quantize_roundtrip` — the QSGD codec's round trip fused into
  the same pass: the dequantized x̂ = q·s/L (``ref.dequantize_ref``, with
  the raw scale) and the error-feedback residual x − x̂, both float32.

The scale (max |x| of each row) stays outside, as the JAX codec computes
it outside the Pallas body (``repro/compress/qsgd.py:50``). The
operations keep the reference's order and IEEE rounding (``x / s * L``,
then ``floor(|v| + u)``, then ``min(·, L)``, then the sign; ``q * s``
then ``/ L``), so both versions reproduce the reference's q exactly.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build

Tensor = torch.Tensor
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
EPS = 1e-12


def stochastic_quantize_plain(x: Tensor, scale: Tensor, noise: Tensor,
                              levels: int, eps: float = EPS) -> Tensor:
    """int32 levels in [-levels, levels] (``ref.stochastic_quantize_ref``)."""
    s = torch.clamp(scale.reshape(-1, 1).to(torch.float32), min=eps)
    v = x.to(torch.float32) / s * levels
    xi = torch.clamp(torch.floor(torch.abs(v) + noise.to(torch.float32)),
                     max=float(levels))
    return (torch.sign(v) * xi).to(torch.int32)


def quantize_roundtrip_plain(x: Tensor, scale: Tensor, noise: Tensor,
                             levels: int, eps: float = EPS
                             ) -> Tuple[Tensor, Tensor]:
    """(x̂, x − x̂), float32: x̂ = q·scale/L (q through int32, so a zero
    level dequantizes to +0 as in the reference). L is a device tensor:
    PyTorch's CUDA division by a Python scalar multiplies by its
    reciprocal, which is not the IEEE quotient the reference takes."""
    q = stochastic_quantize_plain(x, scale, noise, levels, eps)
    s = scale.reshape(-1, 1).to(torch.float32)
    L = torch.full((), float(levels), dtype=torch.float32, device=x.device)
    x_hat = q.to(torch.float32) * s / L
    return x_hat, x.to(torch.float32) - x_hat


def _lib():
    lib = _build.load("stochastic_quantize")
    fn = lib.stochastic_quantize_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, ctypes.c_int, p, p, ctypes.c_int, ctypes.c_float,
                       p, p, p, ctypes.c_int, ctypes.c_longlong, p]
        fn.restype = ctypes.c_int
    return fn


def _launch(x: Tensor, scale: Tensor, noise: Tensor, levels: int,
            eps: float, q, x_hat, res) -> None:
    n, d = x.shape
    if x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError("stochastic_quantize: x must be contiguous "
                         "float32/bfloat16")
    if noise.shape != (n, d) or noise.dtype != torch.float32 \
            or not noise.is_contiguous() or noise.device != x.device:
        raise ValueError(f"stochastic_quantize: noise must be contiguous "
                         f"float32 {(n, d)} on {x.device}")
    if scale.shape != (n,):
        raise ValueError(f"stochastic_quantize: scale {tuple(scale.shape)} "
                         f"!= ({n},)")
    if levels < 1:
        raise ValueError(f"stochastic_quantize: levels={levels} < 1")
    s = scale.to(x.device, torch.float32).contiguous()

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _lib()(x.data_ptr(), _DTYPES[x.dtype], s.data_ptr(),
                 noise.data_ptr(), levels, eps, ptr(q), ptr(x_hat), ptr(res),
                 n, d, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "stochastic_quantize")
    stochastic_quantize.launches += 1


def stochastic_quantize(x: Tensor, scale: Tensor, noise: Tensor, *,
                        levels: int, eps: float = EPS) -> Tensor:
    """int32 levels of x (N, D) f32/bf16. CPU tensors take
    :func:`stochastic_quantize_plain`; CUDA tensors launch the kernel (or
    raise)."""
    if x.device.type == "cpu":
        return stochastic_quantize_plain(x, scale, noise, levels, eps)
    q = torch.empty(x.shape, dtype=torch.int32, device=x.device)
    _launch(x, scale, noise, levels, eps, q, None, None)
    return q


def quantize_roundtrip(x: Tensor, scale: Tensor, noise: Tensor, *,
                       levels: int, eps: float = EPS
                       ) -> Tuple[Tensor, Tensor]:
    """(x̂, x − x̂) float32 in one pass. CPU tensors take
    :func:`quantize_roundtrip_plain`; CUDA tensors launch the kernel (or
    raise)."""
    if x.device.type == "cpu":
        return quantize_roundtrip_plain(x, scale, noise, levels, eps)
    x_hat = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    res = torch.empty_like(x_hat)
    _launch(x, scale, noise, levels, eps, None, x_hat, res)
    return x_hat, res


stochastic_quantize.launches = 0
