"""Dense FFN variants: SwiGLU / GeGLU / plain GELU (the port's copy of
``repro/models/mlp.py``; the RWKV channel mix comes with RWKV6)."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init, gelu

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
        act = torch.nn.functional.silu if cfg.ffn_act == "swiglu" else gelu
        h = act(x @ params["w_gate"]) * (x @ params["w_up"])
    else:
        h = gelu(x @ params["w_up"])
    return h @ params["w_down"]
