"""Dense FFN variants: SwiGLU / GeGLU / plain GELU, plus the RWKV
channel mix of "W" layers (the port's copy of ``repro/models/mlp.py``)."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import act_fn, dense_init, gelu

Tensor = torch.Tensor


def init_mlp(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32
             ) -> Dict[str, Tensor]:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.ffn_act in ("swiglu", "geglu"):
        return {"w_gate": dense_init(gen, (d, f), dtype=dtype),
                "w_up": dense_init(gen, (d, f), dtype=dtype),
                "w_down": dense_init(gen, (f, d), dtype=dtype)}
    return {"w_up": dense_init(gen, (d, f), dtype=dtype),
            "w_down": dense_init(gen, (f, d), dtype=dtype)}


def mlp_forward(params, x: Tensor, cfg: ModelConfig) -> Tensor:
    if cfg.ffn_act in ("swiglu", "geglu"):
        act = act_fn("silu" if cfg.ffn_act == "swiglu" else "gelu")
        h = act(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        h = gelu(x @ params["w_up"])
    return h @ params["w_down"]


def init_channel_mix(gen: torch.Generator, cfg: ModelConfig,
                     dtype=torch.float32) -> Dict[str, Tensor]:
    """RWKV channel mix: squared-ReLU key path with a receptance gate."""
    d, f = cfg.d_model, cfg.d_ff
    return {"w_k": dense_init(gen, (d, f), dtype=dtype),
            "w_v": dense_init(gen, (f, d), dtype=dtype),
            "w_r": dense_init(gen, (d, d), dtype=dtype),
            "mu_k": torch.full((d,), 0.5, dtype=dtype, device=gen.device),
            "mu_r": torch.full((d,), 0.5, dtype=dtype, device=gen.device)}


def _token_shift(x: Tensor, prev: Optional[Tensor] = None) -> Tensor:
    """RWKV token shift: the previous position's activations (zeros, or
    ``prev`` (B, D), at t = 0). x: (B, T, D)."""
    first = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None, :]
    return torch.cat([first, x[:, :-1]], dim=1)


def channel_mix_forward(params, x: Tensor, prev: Optional[Tensor] = None
                        ) -> Tensor:
    xs = _token_shift(x, prev)
    xk = x * params["mu_k"] + xs * (1.0 - params["mu_k"])
    xr = x * params["mu_r"] + xs * (1.0 - params["mu_r"])
    k = torch.square(torch.relu(xk @ params["w_k"]))
    return torch.sigmoid(xr @ params["w_r"]) * (k @ params["w_v"])
