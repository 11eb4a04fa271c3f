"""Shared layers of the model zoo (the port's copy of the parts of
``repro/models/common.py`` the serving and training paths use): plain
functions over tensors, parameters in plain dicts."""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

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


def remat(fn: Callable, *args):
    """``fn(*args)``, rematerialized in the backward when autograd
    records (the reference's ``jax.checkpoint``): only ``args`` are
    saved, and the backward reruns ``fn`` for the rest."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False)


def chunked_cross_entropy(logits_fn: Callable[[Tensor], Tensor],
                          hidden: Tensor, labels: Tensor, mask: Tensor, *,
                          chunk: int = 512,
                          logit_softcap_val: float = 0.0) -> Tensor:
    """Memory-efficient LM loss: a loop over sequence chunks, each chunk's
    loss rematerialized (:func:`remat`), so the (B, S, vocab) logits are
    never held and the backward keeps one (B, chunk, vocab) chunk at a
    time. ``logits_fn(h_chunk) -> (B, c, V)``; labels/mask: (B, S); a
    remainder S mod ``chunk`` is one last, shorter chunk. Returns the
    mean NLL over masked positions (the reference's sharding hints have
    no counterpart on one device)."""
    s = hidden.shape[1]
    chunk = min(chunk, s)
    n_chunks = s // chunk
    rem = s - n_chunks * chunk

    def chunk_loss(h: Tensor, y: Tensor, m: Tensor) -> Tensor:
        logits = softcap(logits_fn(h), logit_softcap_val).to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, y[..., None].long())[..., 0]
        return torch.sum((logz - gold) * m)

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + remat(chunk_loss, hidden[:, sl], labels[:, sl],
                              mask[:, sl])
    if rem:
        total = total + remat(chunk_loss, hidden[:, -rem:], labels[:, -rem:],
                              mask[:, -rem:])
    denom = torch.clamp(torch.sum(mask.to(torch.float32)), min=1.0)
    return total / denom
