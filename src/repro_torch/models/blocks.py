"""Per-layer block: pre-norm mixer (attention / RG-LRU) + pre-norm dense
FFN, with the reference's cache protocol for decode (the port's copy of
``repro/models/blocks.py``). RWKV6, MoE and cross-attention layers raise
``NotImplementedError`` naming the ROADMAP item they wait for."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ATTN_BLOCKS, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models.common import rms_norm

Tensor = torch.Tensor
Params = Dict[str, Any]


def check_layer(layer_type: str, is_moe: bool = False,
                cross: bool = False) -> None:
    """Raise for a layer kind the port does not run yet."""
    if layer_type == "W":
        raise NotImplementedError("RWKV6 (\"W\") layers are not ported yet "
                                  "(ROADMAP.md A.10)")
    if is_moe:
        raise NotImplementedError("MoE FFN layers are not ported yet "
                                  "(ROADMAP.md A.10)")
    if cross:
        raise NotImplementedError("cross-attention comes with Whisper "
                                  "(ROADMAP.md A.10)")
    if layer_type not in ATTN_BLOCKS + ("R",):
        raise ValueError(layer_type)


def init_layer(gen: torch.Generator, cfg: ModelConfig, layer_type: str,
               is_moe: bool = False, dtype=torch.float32,
               cross: bool = False) -> Params:
    check_layer(layer_type, is_moe, cross)
    d = cfg.d_model
    p: Params = {"norm1": torch.zeros(d, dtype=dtype, device=gen.device),
                 "norm2": torch.zeros(d, dtype=dtype, device=gen.device)}
    if layer_type in ATTN_BLOCKS:
        p["mixer"] = attn.init_attn(gen, cfg, dtype)
    else:
        p["mixer"] = rglru_mod.init_rglru(gen, cfg, dtype)
    p["ffn"] = mlp_mod.init_mlp(gen, cfg, dtype)
    return p


def _norm(x: Tensor, scale: Tensor, cfg: ModelConfig) -> Tensor:
    return rms_norm(x, scale, cfg.norm_eps, gemma_style=True)


def _layer_seq(p: Params, x: Tensor, cfg: ModelConfig, layer_type: str,
               max_len: Optional[int]) -> Tuple[Tensor, Optional[Params]]:
    """Full-sequence layer over positions 0..T-1; with ``max_len`` also
    the layer's cache (in the activations' dtype)."""
    cache = None
    h = _norm(x, p["norm1"], cfg)
    if layer_type in ATTN_BLOCKS:
        if max_len is None:
            m = attn.attn_forward(p["mixer"], h, cfg=cfg,
                                  layer_type=layer_type)
        else:
            m, c = attn.attn_prefill(p["mixer"], h, cfg=cfg,
                                     layer_type=layer_type, max_len=max_len)
            cache = {"attn": c}
    else:
        m, st = rglru_mod.rglru_prefill(p["mixer"], h, cfg)
        if max_len is not None:
            cache = {"rec": st}
    x = x + m
    h2 = _norm(x, p["norm2"], cfg)
    return x + mlp_mod.mlp_forward(p["ffn"], h2, cfg), cache


def layer_forward(p: Params, x: Tensor, *, cfg: ModelConfig, layer_type: str,
                  is_moe: bool = False) -> Tuple[Tensor, Tensor]:
    """Full-sequence layer over positions 0..T-1. Returns (x, aux_loss)
    (aux is 0: no MoE)."""
    check_layer(layer_type, is_moe)
    out, _ = _layer_seq(p, x, cfg, layer_type, None)
    return out, torch.zeros((), dtype=torch.float32, device=x.device)


def layer_prefill(p: Params, x: Tensor, *, cfg: ModelConfig,
                  layer_type: str, max_len: int) -> Tuple[Tensor, Params]:
    """:func:`layer_forward` over positions 0..T-1 that also returns the
    layer's decode cache, equal to what T decode steps from
    :func:`init_layer_cache` leave: for "R" the scan's last state and the
    conv's last W-1 inputs, for attention the ring of the last
    min(T, cache_len) keys and values (see ``attn.attn_prefill``)."""
    check_layer(layer_type)
    return _layer_seq(p, x, cfg, layer_type, max_len)


def init_layer_cache(cfg: ModelConfig, layer_type: str, batch: int,
                     max_len: int, dtype=torch.float32, device=None
                     ) -> Params:
    check_layer(layer_type)
    if layer_type in ATTN_BLOCKS:
        return {"attn": attn.init_attn_cache(cfg, layer_type, batch, max_len,
                                             dtype, device)}
    return {"rec": rglru_mod.init_rglru_state(cfg, batch, dtype, device)}


def layer_decode(p: Params, x: Tensor, cache: Params, index: int, *,
                 cfg: ModelConfig, layer_type: str, is_moe: bool = False
                 ) -> Tuple[Tensor, Params]:
    """Single-token decode. x: (B, 1, D). Attention caches are updated in
    place (``attn.attn_decode``)."""
    check_layer(layer_type, is_moe)
    new_cache = dict(cache)
    h = _norm(x, p["norm1"], cfg)
    if layer_type in ATTN_BLOCKS:
        m, new_cache["attn"] = attn.attn_decode(
            p["mixer"], h, cache["attn"], index, cfg=cfg,
            layer_type=layer_type)
    else:
        m, new_cache["rec"] = rglru_mod.rglru_decode(p["mixer"], h,
                                                     cache["rec"], cfg)
    x = x + m
    h2 = _norm(x, p["norm2"], cfg)
    return x + mlp_mod.mlp_forward(p["ffn"], h2, cfg), new_cache
