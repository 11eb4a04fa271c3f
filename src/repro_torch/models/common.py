"""Shared layers of the model zoo (the port's copy of the parts of
``repro/models/common.py`` the serving path uses): plain functions over
tensors, parameters in plain dicts."""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

Tensor = torch.Tensor


def dense_init(gen: torch.Generator, shape: Sequence[int],
               scale: Optional[float] = None, dtype=torch.float32) -> Tensor:
    """Truncated-normal fan-in init: std * N(0, 1) truncated to [-2, 2]
    (std = ``scale`` or 1/sqrt(shape[0])), drawn in fp32 from ``gen`` on
    its device and cast to ``dtype``."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std,
                                generator=gen)
    return w.to(dtype)


def rms_norm(x: Tensor, scale: Tensor, eps: float = 1e-6,
             gemma_style: bool = True) -> Tensor:
    """RMSNorm in fp32; ``gemma_style`` uses the (1 + w) convention."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    w = scale.to(torch.float32)
    y = y * (1.0 + w) if gemma_style else y * w
    return y.to(x.dtype)


def softcap(x: Tensor, cap: float) -> Tensor:
    """Gemma-2 soft capping: cap * tanh(x / cap). No-op if cap <= 0."""
    if cap <= 0.0:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., T, H, hd); positions: broadcastable to (..., T). Rotates
    the two halves of the head dimension (``jnp.split``), not
    interleaved pairs."""
    if theta <= 0.0:
        return x
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)           # (hd/2,)
    ang = positions[..., :, None, None].to(torch.float32) * freqs
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def gelu(x: Tensor) -> Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation (PyTorch's
    default is the exact erf form)."""
    return torch.nn.functional.gelu(x, approximate="tanh")
