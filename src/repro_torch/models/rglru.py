"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427):
the port's copy of ``repro/models/rglru.py``.

Block: x -> [gate branch: GeLU(W_gate x)] * [recurrent branch:
W_in x -> causal conv1d(width w) -> RG-LRU] -> W_out.

RG-LRU (per channel):
  r_t = sigmoid(W_a x_t)            recurrence gate
  i_t = sigmoid(W_i x_t)            input gate
  log a_t = -c * softplus(Lambda) * r_t          (c = 8)
  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The full-sequence recurrence goes through ``kernels.ops.linear_scan``:
the CUDA kernel for tensors on the card, its plain version on the CPU
(the wrapper's device decides; there is no switch), differentiable in
both (its backward is the same scan in reverse time, through the same
kernel on the card). Decode is a single-step state update and launches
no kernel.

Over a mesh (``tp``), each rank computes one block of the rd channels:
the block its weights hold where the rules cut them over ``model``
(``w_in`` / ``w_gate`` / ``w_a`` / ``w_i`` / ``conv_w`` on their columns,
``w_out`` on its rows; whole leaves are cut here), else, at batch 1 over
the data axes, the block its state ``h`` holds. The conv's output is
all-gathered once to feed the column-parallel gates, the scan runs on
the rank's (B, T, rd / ranks) block, ``w_out``'s partial products are
summed over the axis, and the state is written as the cache's specs
store it (gathered where the cache holds every channel).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import dense_init, gelu

Tensor = torch.Tensor
_C = 8.0


def init_rglru(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32
               ) -> Dict[str, Tensor]:
    d = cfg.d_model
    rd = cfg.rg_lru_dim or d
    # Lambda init so that a spans ~(0.9, 0.999) at r=1 (Griffin appendix)
    u = torch.empty(rd, dtype=torch.float32, device=gen.device).uniform_(
        0.9, 0.999, generator=gen)
    lam = torch.log(torch.expm1(-torch.log(u) / _C))  # softplus^-1(-log u / c)
    return {
        "w_in": dense_init(gen, (d, rd), dtype=dtype),
        "w_gate": dense_init(gen, (d, rd), dtype=dtype),
        "w_out": dense_init(gen, (rd, d), dtype=dtype),
        "w_a": dense_init(gen, (rd, rd), scale=0.02, dtype=dtype),
        "w_i": dense_init(gen, (rd, rd), scale=0.02, dtype=dtype),
        "conv_w": dense_init(gen, (cfg.conv1d_width, rd), scale=0.02,
                             dtype=dtype),
        "lambda": lam.to(dtype),
    }


def _causal_conv1d(x: Tensor, w: Tensor, state: Optional[Tensor] = None
                   ) -> Tensor:
    """Depthwise causal conv. x: (B, T, C), w: (W, C).
    ``state``: (B, W-1, C) trailing context for decode continuity; None
    is W-1 zero rows (the reference pads min(T, W-1) rows, which differs
    only for T < W-1)."""
    width = w.shape[0]
    pad = x.new_zeros(x.shape[0], width - 1, x.shape[2]) \
        if state is None else state
    xp = torch.cat([pad, x], dim=1)
    out = 0
    for i in range(width):
        out = out + xp[:, i: i + x.shape[1]] * w[i]
    return out


# the dim of each leaf that holds the rd channels
_CHANNELS = {"w_in": 1, "w_gate": 1, "w_a": 1, "w_i": 1, "conv_w": 1,
             "w_out": 0}


def _split(tp):
    """(``models.parallel``, the axis whose ranks compute a block of the
    channels: size 1 off a mesh)."""
    from repro_torch.models import parallel as par
    return par, par.split_axis(tp, _CHANNELS, "h", 1)


def _gates(params, u: Tensor, tp, ax) -> Tuple[Tensor, Tensor]:
    """(a, gated input) of the conv's output ``u``: the channels of
    ``ax``'s block, the gates' input gathered whole over it."""
    from repro_torch.models import parallel as par
    uf = par.gather_over(u, ax, -1)
    r = torch.sigmoid(uf @ par.take(tp, params, "w_a", 1, ax))
    i = torch.sigmoid(uf @ par.take(tp, params, "w_i", 1, ax))
    log_a = -_C * torch.nn.functional.softplus(
        par.block(params["lambda"], ax, 0).to(torch.float32)) * r
    a = torch.exp(log_a).to(u.dtype)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, 1e-12, 1.0)) * i * u
    return a, gated


def rglru_scan(a: Tensor, b: Tensor, h0: Optional[Tensor] = None) -> Tensor:
    """h_t = a_t * h_{t-1} + b_t along axis 1 through
    ``ops.linear_scan`` (differentiable), with an optional carried state
    ``h0`` (B, D) folded into the first step."""
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    return ops.linear_scan(a, b)


def rglru_prefill(params, x: Tensor, cfg: ModelConfig, tp=None
                  ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Full-sequence forward of x (B, T, D) that also returns the decode
    state after the last position: ``h`` = the scan's last row and
    ``conv`` = the last W-1 rows of ``x @ w_in`` (before the conv),
    zero-padded on the left when T < W-1. Over a mesh (``tp``), this
    rank's channel block (see the module's docstring) and its shard of
    the state."""
    par, ax = _split(tp)

    def w(name, dim):
        return par.take(tp, params, name, dim, ax)
    gate = gelu(x @ w("w_gate", 1))
    u = x @ w("w_in", 1)
    a, b = _gates(params, _causal_conv1d(u, w("conv_w", 1)), tp, ax)
    h = ops.linear_scan(a, b)
    y = par.sum_over((h * gate) @ w("w_out", 0), ax)
    keep = cfg.conv1d_width - 1
    tail = u[:, max(u.shape[1] - keep, 0):]
    if tail.shape[1] < keep:
        tail = torch.cat([tail.new_zeros(tail.shape[0],
                                         keep - tail.shape[1],
                                         tail.shape[2]), tail], dim=1)
    return y, _state(par, tp, ax, h[:, -1], tail)


def _state(par, tp, ax, h: Tensor, conv: Tensor) -> Dict[str, Tensor]:
    """The cache's ``h`` and ``conv`` from ``ax``'s channel block of them:
    one all-gather of both over ``ax``, ``h`` then cut to this rank's
    block where the cache cuts its channels over the data axes (the
    block as it is in a forward that keeps no cache)."""
    if ax.size == 1 or tp.cspecs is None:      # or no cache is kept
        return {"h": par.to_cache(tp, h, "h", 1), "conv": conv}
    both = par.gather_over(torch.cat([conv, h[:, None]], 1), ax, -1)
    return {"h": par.to_cache(tp, both[:, -1], "h", 1).contiguous(),
            "conv": both[:, :-1].contiguous()}


def rglru_forward(params, x: Tensor, cfg: ModelConfig, tp=None) -> Tensor:
    """Full-sequence forward. x: (B, T, D)."""
    return rglru_prefill(params, x, cfg, tp)[0]


def init_rglru_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> Dict[str, Tensor]:
    rd = cfg.rg_lru_dim or cfg.d_model
    return {"h": torch.zeros((batch, rd), dtype=dtype, device=device),
            "conv": torch.zeros((batch, cfg.conv1d_width - 1, rd),
                                dtype=dtype, device=device)}


def rglru_decode(params, x: Tensor, state: Dict[str, Tensor],
                 cfg: ModelConfig, tp=None
                 ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One-token decode. x: (B, 1, D). Over a mesh (``tp``), this rank's
    channel block, the state read from and written to its shard."""
    par, ax = _split(tp)

    def w(name, dim):
        return par.take(tp, params, name, dim, ax)
    gate = gelu(x @ w("w_gate", 1))
    u = x @ w("w_in", 1)                                     # (B, 1, rd)
    conv = par.from_cache(tp, state["conv"], "conv", 2, ax)
    conv_in = torch.cat([conv, u], dim=1)                    # (B, W, rd)
    u_c = torch.einsum("bwc,wc->bc", conv_in, w("conv_w", 1))[:, None]
    a, b = _gates(params, u_c, tp, ax)
    h = a[:, 0] * par.from_cache(tp, state["h"], "h", 1, ax) + b[:, 0]
    y = par.sum_over((h[:, None] * gate) @ w("w_out", 0), ax)
    return y, _state(par, tp, ax, h, conv_in[:, 1:])
