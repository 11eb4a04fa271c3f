"""Per-layer block: pre-norm mixer (attention / RG-LRU / RWKV6) +
pre-norm FFN (dense / MoE / RWKV channel mix), with the reference's
cache protocol for decode (the port's copy of ``repro/models/blocks.py``).
Cross-attention layers raise ``NotImplementedError`` naming the missing
feature."""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ATTN_BLOCKS, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mlp as mlp_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.common import rms_norm

Tensor = torch.Tensor
Params = Dict[str, Any]


def check_layer(layer_type: str, is_moe: bool = False,
                cross: bool = False) -> None:
    """Raise for a layer kind the port does not run yet."""
    if cross:
        raise NotImplementedError("cross-attention layers (Whisper's "
                                  "decoder) are not ported yet")
    if layer_type not in ATTN_BLOCKS + ("R", "W"):
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
    elif layer_type == "R":
        p["mixer"] = rglru_mod.init_rglru(gen, cfg, dtype)
    else:
        p["mixer"] = rwkv_mod.init_rwkv6(gen, cfg, dtype)
    if layer_type == "W":
        p["ffn"] = mlp_mod.init_channel_mix(gen, cfg, dtype)
    elif is_moe:
        p["ffn"] = moe_mod.init_moe(gen, cfg, dtype)
    else:
        p["ffn"] = mlp_mod.init_mlp(gen, cfg, dtype)
    return p


def _norm(x: Tensor, scale: Tensor, cfg: ModelConfig) -> Tensor:
    return rms_norm(x, scale, cfg.norm_eps, gemma_style=True)


def _layer_seq(p: Params, x: Tensor, cfg: ModelConfig, layer_type: str,
               is_moe: bool, max_len: Optional[int]
               ) -> Tuple[Tensor, Tensor, Optional[Params]]:
    """Full-sequence layer over positions 0..T-1: (x, aux_loss, cache);
    with ``max_len`` the layer's cache (in the activations' dtype) and an
    MoE FFN routing each position's B tokens as a group (the reference's
    decode-step prefill), without it the cache None and all B·T tokens
    one group (the reference's forward)."""
    cache: Optional[Params] = None if max_len is None else {}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = _norm(x, p["norm1"], cfg)
    if layer_type in ATTN_BLOCKS:
        if max_len is None:
            m = attn.attn_forward(p["mixer"], h, cfg=cfg,
                                  layer_type=layer_type)
        else:
            m, cache["attn"] = attn.attn_prefill(
                p["mixer"], h, cfg=cfg, layer_type=layer_type,
                max_len=max_len)
    else:
        prefill = (rglru_mod.rglru_prefill if layer_type == "R"
                   else rwkv_mod.rwkv6_prefill)
        m, st = prefill(p["mixer"], h, cfg)
        if cache is not None:
            cache["rec"] = st
    x = x + m
    h2 = _norm(x, p["norm2"], cfg)
    if layer_type == "W":
        f = mlp_mod.channel_mix_forward(p["ffn"], h2)
        if cache is not None:
            cache["ffn_prev"] = h2[:, -1]
    elif is_moe:
        group = None if max_len is None else x.shape[0]
        f, aux = moe_mod.moe_forward(p["ffn"], h2, cfg, group=group)
    else:
        f = mlp_mod.mlp_forward(p["ffn"], h2, cfg)
    return x + f, aux, cache


def layer_forward(p: Params, x: Tensor, *, cfg: ModelConfig, layer_type: str,
                  is_moe: bool = False) -> Tuple[Tensor, Tensor]:
    """Full-sequence layer over positions 0..T-1. Returns (x, aux_loss)
    (aux is 0 but for an MoE FFN)."""
    check_layer(layer_type, is_moe)
    out, aux, _ = _layer_seq(p, x, cfg, layer_type, is_moe, None)
    return out, aux


def layer_prefill(p: Params, x: Tensor, *, cfg: ModelConfig,
                  layer_type: str, max_len: int, is_moe: bool = False
                  ) -> Tuple[Tensor, Params]:
    """:func:`layer_forward` over positions 0..T-1 that also returns the
    layer's decode cache, equal to what T decode steps from
    :func:`init_layer_cache` leave: for "R" the scan's last state and the
    conv's last W-1 inputs, for "W" the state after position T-1 and the
    last normed inputs of the mixer and of the channel mix, for attention
    the ring of the last min(T, cache_len) keys and values (see
    ``attn.attn_prefill``). An MoE FFN routes each position's tokens as
    those decode steps do, with their capacity."""
    check_layer(layer_type, is_moe)
    out, _, cache = _layer_seq(p, x, cfg, layer_type, is_moe, max_len)
    return out, cache


def init_layer_cache(cfg: ModelConfig, layer_type: str, batch: int,
                     max_len: int, dtype=torch.float32, device=None
                     ) -> Params:
    check_layer(layer_type)
    if layer_type in ATTN_BLOCKS:
        return {"attn": attn.init_attn_cache(cfg, layer_type, batch, max_len,
                                             dtype, device)}
    if layer_type == "R":
        return {"rec": rglru_mod.init_rglru_state(cfg, batch, dtype, device)}
    return {"rec": rwkv_mod.init_rwkv6_state(cfg, batch, dtype, device),
            "ffn_prev": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                    device=device)}


def layer_decode(p: Params, x: Tensor, cache: Params, index: int, *,
                 cfg: ModelConfig, layer_type: str, is_moe: bool = False
                 ) -> Tuple[Tensor, Params]:
    """Single-token decode. x: (B, 1, D). Attention caches are updated in
    place (``attn.attn_decode``); an MoE FFN routes the B tokens as one
    group and drops its aux loss."""
    check_layer(layer_type, is_moe)
    new_cache = dict(cache)
    h = _norm(x, p["norm1"], cfg)
    if layer_type in ATTN_BLOCKS:
        m, new_cache["attn"] = attn.attn_decode(
            p["mixer"], h, cache["attn"], index, cfg=cfg,
            layer_type=layer_type)
    elif layer_type == "R":
        m, new_cache["rec"] = rglru_mod.rglru_decode(p["mixer"], h,
                                                     cache["rec"], cfg)
    else:
        m, new_cache["rec"] = rwkv_mod.rwkv6_decode(p["mixer"], h,
                                                    cache["rec"], cfg)
    x = x + m
    h2 = _norm(x, p["norm2"], cfg)
    if layer_type == "W":
        f = mlp_mod.channel_mix_forward(p["ffn"], h2,
                                        prev=cache["ffn_prev"])
        new_cache["ffn_prev"] = h2[:, 0]
    elif is_moe:
        f, _ = moe_mod.moe_forward(p["ffn"], h2, cfg)
    else:
        f = mlp_mod.mlp_forward(p["ffn"], h2, cfg)
    return x + f, new_cache
