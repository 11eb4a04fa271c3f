"""Decoder assembled from blocks, with the chunked LM loss, a prefill
that fills the decode cache and a one-token decode step (the port's copy
of ``repro/models/transformer.py`` for decoder-only models).

The reference stacks the layers of repeated pattern cycles into
``scanned`` groups for ``lax.scan``; PyTorch loops in Python, so the port
keeps one list, ``params["layers"][i]`` and ``cache["layers"][i]``
(``repro_torch.convert`` unstacks). ``encode`` waits for the Whisper
slice.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks
from repro_torch.models.common import (chunked_cross_entropy, dense_init,
                                       remat, rms_norm, softcap)
from repro_torch.tree import tree_leaves

Tensor = torch.Tensor
Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a configuration the port does not run yet."""
    if cfg.is_encdec:
        raise NotImplementedError("encoder-decoder models (Whisper's "
                                  "encoder) are not ported yet")
    if cfg.vis_tokens:
        raise NotImplementedError("the VLM image prefix (PaliGemma) is not "
                                  "ported yet")
    if cfg.rope_theta <= 0 and cfg.family != "ssm":
        raise NotImplementedError("sinusoidal positions (Whisper) are not "
                                  "ported yet")
    for i, lt in enumerate(cfg.layer_types()):
        blocks.check_layer(lt, cfg.is_moe_layer(i))


# ---------------------------------------------------------------------------
# init

def init_params(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32
                ) -> Params:
    """Random weights drawn from ``gen`` on its device, layer by layer,
    then the embedding (and the LM head when untied)."""
    check_supported(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    layers = [blocks.init_layer(gen, cfg, lt, cfg.is_moe_layer(i), dtype)
              for i, lt in enumerate(cfg.layer_types())]
    params: Params = {
        "embed": dense_init(gen, (v, d), scale=0.02, dtype=dtype),
        "layers": layers,
        "final_norm": torch.zeros(d, dtype=dtype, device=gen.device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (d, v), dtype=dtype)
    return params


def param_count(params: Params) -> int:
    """The number of weights actually held (the config's analytic
    ``param_count`` undercounts the RG-LRU and RWKV6 layers and leaves
    out ``final_norm``)."""
    return sum(x.numel() for x in tree_leaves(params))


# ---------------------------------------------------------------------------
# forward (prefill)

def _embed(params, cfg: ModelConfig, tokens: Tensor) -> Tensor:
    x = params["embed"][tokens]
    if cfg.emb_scale:
        # the reference scales by sqrt(d_model) cast to the working dtype
        # first (50.5, not 50.596, in bf16 at d_model 2560)
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype).item()
    return x


def logits_fn(params, cfg: ModelConfig, h: Tensor) -> Tensor:
    return h @ params["embed"].T if cfg.tie_embeddings \
        else h @ params["lm_head"]


def _run_layers(params, cfg: ModelConfig, x: Tensor, *,
                max_len: Optional[int] = None
                ) -> Tuple[Tensor, Tensor, Optional[List[Params]]]:
    """Apply all decoder layers over positions 0..T-1: (hidden, the sum
    of the layers' aux losses, caches); with ``max_len`` also each
    layer's decode cache (and the aux 0: prefill drops it). Without it
    and with ``cfg.remat``, each layer is rematerialized in the backward
    (the reference's ``jax.checkpoint`` per layer): only the layer
    boundaries are saved."""
    caches = [] if max_len is not None else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, (lp, lt) in enumerate(zip(params["layers"], cfg.layer_types())):
        moe = cfg.is_moe_layer(i)
        if max_len is None:
            fwd = partial(blocks.layer_forward, cfg=cfg, layer_type=lt,
                          is_moe=moe)
            x, a = remat(fwd, lp, x) if cfg.remat else fwd(lp, x)
            aux = aux + a
        else:
            x, c = blocks.layer_prefill(lp, x, cfg=cfg, layer_type=lt,
                                        max_len=max_len, is_moe=moe)
            caches.append(c)
    return x, aux, caches


def forward_hidden(params, cfg: ModelConfig, batch: Dict[str, Tensor]
                   ) -> Tuple[Tensor, Tensor, int]:
    """Embed and run the layers. Returns (hidden (B,S,D), aux_loss,
    text_offset): the MoE layers' aux losses summed (0 without MoE), the
    offset 0 (no modality prefix)."""
    check_supported(cfg)
    x = _embed(params, cfg, batch["tokens"])
    h, aux, _ = _run_layers(params, cfg, x)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return h, aux, 0


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, Tensor],
            loss_chunk: int = 512) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Next-token LM loss (+ the MoE aux). ``batch``: tokens
    (B, S), optional labels and mask (default: the tokens shifted left,
    the last position masked)."""
    h, aux, off = forward_hidden(params, cfg, batch)
    tokens = batch["tokens"]
    labels = batch.get("labels")
    if labels is None:
        labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                           dim=1)
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=labels.device)
        mask[:, -1] = 0.0
    lm = chunked_cross_entropy(
        lambda hc: logits_fn(params, cfg, hc), h[:, off:], labels,
        mask.to(torch.float32), chunk=loss_chunk,
        logit_softcap_val=cfg.logit_softcap)
    return lm + aux, {"lm_loss": lm, "aux_loss": aux}


def prefill_hidden(params, cfg: ModelConfig, tokens: Tensor, max_len: int
                   ) -> Tuple[Tensor, Params]:
    """:func:`forward_hidden` through ``blocks.layer_prefill``: (hidden,
    cache) with the cache as T decode steps would have left it."""
    check_supported(cfg)
    x = _embed(params, cfg, tokens)
    h, _, caches = _run_layers(params, cfg, x, max_len=max_len)
    return rms_norm(h, params["final_norm"], cfg.norm_eps), {"layers": caches}


# ---------------------------------------------------------------------------
# decode

def init_cache(params, cfg: ModelConfig, batch: int, max_len: int
               ) -> Params:
    """An empty decode cache in the weights' dtype on their device (the
    decode path computes in one dtype, so the cache takes the weights')."""
    check_supported(cfg)
    emb = params["embed"]
    return {"layers": [
        blocks.init_layer_cache(cfg, lt, batch, max_len, emb.dtype,
                                emb.device)
        for lt in cfg.layer_types()]}


def decode_step(params, cfg: ModelConfig, cache: Params, token: Tensor,
                index: int) -> Tuple[Tensor, Params]:
    """One decode step. token: (B,) integer; index: the absolute position
    (a Python int). Returns (logits (B, V), new cache); attention caches
    are updated in place."""
    x = _embed(params, cfg, token[:, None])
    new_layers = []
    for i, (lp, lc, lt) in enumerate(zip(params["layers"], cache["layers"],
                                         cfg.layer_types())):
        x, nc = blocks.layer_decode(lp, x, lc, index, cfg=cfg, layer_type=lt,
                                    is_moe=cfg.is_moe_layer(i))
        new_layers.append(nc)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = softcap(logits_fn(params, cfg, h)[:, 0], cfg.logit_softcap)
    return logits, {"layers": new_layers}
