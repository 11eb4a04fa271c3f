"""Per-layer block: pre-norm mixer (attention / RG-LRU / RWKV6), an
encoder-decoder layer's pre-norm cross-attention, then the pre-norm FFN
(dense / MoE / RWKV channel mix), with the reference's cache protocol for
decode (the port's copy of ``repro/models/blocks.py``)."""
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


def check_layer(layer_type: str) -> None:
    """Raise for an unknown layer type."""
    if layer_type not in ATTN_BLOCKS + ("R", "W"):
        raise ValueError(layer_type)


def init_layer(gen: torch.Generator, cfg: ModelConfig, layer_type: str,
               is_moe: bool = False, dtype=torch.float32,
               cross: bool = False) -> Params:
    """One layer's weights drawn from ``gen``: the norms, the mixer, the
    FFN and, with ``cross``, ``norm_x`` and the cross-attention."""
    check_layer(layer_type)
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
    if cross:
        p["norm_x"] = torch.zeros(d, dtype=dtype, device=gen.device)
        p["cross"] = attn.init_attn(gen, cfg, dtype)
    return p


def _norm(x: Tensor, scale: Tensor, cfg: ModelConfig) -> Tensor:
    return rms_norm(x, scale, cfg.norm_eps, gemma_style=True)


def _layer_seq(p: Params, x: Tensor, cfg: ModelConfig, layer_type: str,
               is_moe: bool, max_len: Optional[int], prefix_len: int = 0,
               memory: Optional[Tensor] = None, tp=None
               ) -> Tuple[Tensor, Tensor, Optional[Params]]:
    """Full-sequence layer over positions 0..T-1, the first
    ``prefix_len`` attending both ways: (x, aux_loss, cache); with
    ``max_len`` the layer's cache (in the activations' dtype) and an MoE
    FFN routing each position's B tokens as a group (the reference's
    decode-step prefill), without it the cache None and all B·T tokens
    one group (the reference's forward). A layer with ``cross`` attends
    to ``memory`` after its mixer when memory is given (the reference's
    forward skips it otherwise), and its cache's ``cross`` holds
    memory's keys and values. ``tp``: the layer's place on a mesh
    (``models/parallel.py``), or ``None``."""
    cache: Optional[Params] = None if max_len is None else {}
    mtp, ftp, ctp = _sub_tp(tp, layer_type)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = _norm(x, p["norm1"], cfg)
    if layer_type in ATTN_BLOCKS:
        if max_len is None:
            m = attn.attn_forward(p["mixer"], h, cfg=cfg,
                                  layer_type=layer_type,
                                  prefix_len=prefix_len, tp=mtp)
        else:
            m, cache["attn"] = attn.attn_prefill(
                p["mixer"], h, cfg=cfg, layer_type=layer_type,
                max_len=max_len, tp=mtp)
    else:
        prefill = (rglru_mod.rglru_prefill if layer_type == "R"
                   else rwkv_mod.rwkv6_prefill)
        m, st = prefill(p["mixer"], h, cfg, **_on_mesh(mtp))
        if cache is not None:
            cache["rec"] = st
    x = x + m
    if "cross" in p and memory is not None:
        hx = _norm(x, p["norm_x"], cfg)
        if cache is None:
            x = x + attn.cross_attn_forward(p["cross"], hx, memory, cfg=cfg,
                                            **_on_mesh(ctp))
        else:
            y, kv = attn.cross_attn_prefill(p["cross"], hx, memory, cfg=cfg,
                                            tp=ctp)
            x = x + y
            cache["cross"] = {k: v.to(x.dtype) for k, v in kv.items()}
    h2 = _norm(x, p["norm2"], cfg)
    if layer_type == "W":
        f = mlp_mod.channel_mix_forward(p["ffn"], h2, **_on_mesh(ftp))
        if cache is not None:
            cache["ffn_prev"] = _prev(ftp, h2[:, -1])
    elif is_moe:
        group = None if max_len is None else x.shape[0]
        f, aux = moe_mod.moe_forward(p["ffn"], h2, cfg, group=group,
                                     **_on_mesh(ftp))
    else:
        f = mlp_mod.mlp_forward(p["ffn"], h2, cfg, **_on_mesh(ftp))
    return x + f, aux, cache


def _sub_tp(tp, layer_type: str):
    """(the mixer's, the FFN's, the cross-attention's) places on a mesh,
    or Nones: an attention mixer's cache is the layer's ``attn``, a
    recurrent one's ``rec``; the channel mix's cache its ``prev``, the
    layer's ``ffn_prev``."""
    if tp is None:
        return None, None, None
    rec = layer_type in ("R", "W")
    ftp = (tp.sub("ffn", {"prev": "ffn_prev"}) if layer_type == "W"
           else tp.sub("ffn"))
    return tp.sub("mixer", "rec" if rec else "attn"), ftp, tp.sub("cross")


def _prev(tp, x: Tensor) -> Tensor:
    """The channel mix's ``ffn_prev`` (B, D) as the cache stores it: this
    rank's block of D where the cache cuts it over the data axes."""
    if tp is None:
        return x
    from repro_torch.models.parallel import to_cache
    return to_cache(tp, x, "prev", 1)


def _on_mesh(tp) -> Dict[str, Any]:
    """A module's ``tp`` keyword: none off a mesh, so the module
    functions are called there as they always were."""
    return {} if tp is None else {"tp": tp}


def layer_forward(p: Params, x: Tensor, *, cfg: ModelConfig, layer_type: str,
                  is_moe: bool = False, prefix_len: int = 0,
                  memory: Optional[Tensor] = None, tp=None
                  ) -> Tuple[Tensor, Tensor]:
    """Full-sequence layer over positions 0..T-1, the first
    ``prefix_len`` bidirectional, cross-attending to ``memory`` where the
    layer has ``cross``. Returns (x, aux_loss) (aux is 0 but for an MoE
    FFN)."""
    check_layer(layer_type)
    out, aux, _ = _layer_seq(p, x, cfg, layer_type, is_moe, None,
                             prefix_len, memory, tp)
    return out, aux


def layer_prefill(p: Params, x: Tensor, *, cfg: ModelConfig,
                  layer_type: str, max_len: int, is_moe: bool = False,
                  memory: Optional[Tensor] = None, tp=None
                  ) -> Tuple[Tensor, Params]:
    """:func:`layer_forward` over positions 0..T-1 that also returns the
    layer's decode cache, equal to what T decode steps from
    :func:`init_layer_cache` leave: for "R" the scan's last state and the
    conv's last W-1 inputs, for "W" the state after position T-1 and the
    last normed inputs of the mixer and of the channel mix, for attention
    the ring of the last min(T, cache_len) keys and values (see
    ``attn.attn_prefill``), for cross-attention ``memory``'s keys and
    values. An MoE FFN routes each position's tokens as those decode
    steps do, with their capacity."""
    check_layer(layer_type)
    out, _, cache = _layer_seq(p, x, cfg, layer_type, is_moe, max_len,
                               memory=memory, tp=tp)
    return out, cache


def init_layer_cache(cfg: ModelConfig, layer_type: str, batch: int,
                     max_len: int, dtype=torch.float32, device=None,
                     cross: bool = False) -> Params:
    """An empty decode cache of one layer; with ``cross``, zero
    cross-attention keys and values of ``cfg.enc_frames`` frames."""
    check_layer(layer_type)
    if layer_type in ATTN_BLOCKS:
        c = {"attn": attn.init_attn_cache(cfg, layer_type, batch, max_len,
                                          dtype, device)}
    elif layer_type == "R":
        c = {"rec": rglru_mod.init_rglru_state(cfg, batch, dtype, device)}
    else:
        c = {"rec": rwkv_mod.init_rwkv6_state(cfg, batch, dtype, device),
             "ffn_prev": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                     device=device)}
    if cross:
        shape = (batch, cfg.enc_frames, cfg.n_kv_heads, cfg.resolved_head_dim)
        c["cross"] = {"k": torch.zeros(shape, dtype=dtype, device=device),
                      "v": torch.zeros(shape, dtype=dtype, device=device)}
    return c


def layer_decode(p: Params, x: Tensor, cache: Params, index: int, *,
                 cfg: ModelConfig, layer_type: str, is_moe: bool = False,
                 tp=None) -> Tuple[Tensor, Params]:
    """Single-token decode. x: (B, 1, D). Attention caches are updated in
    place (``attn.attn_decode``); a layer with ``cross`` attends to the
    cached encoder keys and values (which stay as they are); an MoE FFN
    routes the B tokens as one group and drops its aux loss. ``tp``: the
    layer's place on a mesh, or ``None``."""
    check_layer(layer_type)
    mtp, ftp, ctp = _sub_tp(tp, layer_type)
    new_cache = dict(cache)
    h = _norm(x, p["norm1"], cfg)
    if layer_type in ATTN_BLOCKS:
        m, new_cache["attn"] = attn.attn_decode(
            p["mixer"], h, cache["attn"], index, cfg=cfg,
            layer_type=layer_type, tp=mtp)
    elif layer_type == "R":
        m, new_cache["rec"] = rglru_mod.rglru_decode(
            p["mixer"], h, cache["rec"], cfg, **_on_mesh(mtp))
    else:
        m, new_cache["rec"] = rwkv_mod.rwkv6_decode(
            p["mixer"], h, cache["rec"], cfg, **_on_mesh(mtp))
    x = x + m
    if "cross" in p:
        hx = _norm(x, p["norm_x"], cfg)
        x = x + attn.cross_attn_decode(p["cross"], hx, cache["cross"],
                                       cfg=cfg, **_on_mesh(ctp))
    h2 = _norm(x, p["norm2"], cfg)
    if layer_type == "W":
        f = mlp_mod.channel_mix_forward(p["ffn"], h2,
                                        prev=cache["ffn_prev"],
                                        **_on_mesh(ftp))
        new_cache["ffn_prev"] = _prev(ftp, h2[:, 0])
    elif is_moe:
        f, _ = moe_mod.moe_forward(p["ffn"], h2, cfg, **_on_mesh(ftp))
    else:
        f = mlp_mod.mlp_forward(p["ffn"], h2, cfg, **_on_mesh(ftp))
    return x + f, new_cache
