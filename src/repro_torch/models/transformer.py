"""Decoder assembled from blocks, with a prefill that fills the decode
cache and a one-token decode step (the port's copy of the serving parts
of ``repro/models/transformer.py``).

The reference stacks the layers of repeated pattern cycles into
``scanned`` groups for ``lax.scan``; PyTorch loops in Python, so the port
keeps one list, ``params["layers"][i]`` and ``cache["layers"][i]``
(``repro_torch.convert`` unstacks). ``loss_fn`` and ``encode`` wait for
the training and Whisper slices.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks
from repro_torch.models.common import dense_init, rms_norm, softcap

Tensor = torch.Tensor
Params = Dict[str, Any]


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a configuration the port does not run yet."""
    if cfg.is_encdec:
        raise NotImplementedError("encoder-decoder models come with Whisper "
                                  "(ROADMAP.md A.10)")
    if cfg.vis_tokens:
        raise NotImplementedError("the VLM prefix is not ported yet "
                                  "(ROADMAP.md A.10)")
    if cfg.rope_theta <= 0 and cfg.family != "ssm":
        raise NotImplementedError("sinusoidal positions come with Whisper "
                                  "(ROADMAP.md A.10)")
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
    ``param_count`` undercounts the RG-LRU layers and ``final_norm``)."""
    def count(tree) -> int:
        if isinstance(tree, torch.Tensor):
            return tree.numel()
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        return sum(count(v) for v in tree)
    return count(params)


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
                ) -> Tuple[Tensor, Optional[List[Params]]]:
    """Apply all decoder layers over positions 0..T-1; with ``max_len``
    also each layer's decode cache."""
    caches = [] if max_len is not None else None
    for lp, lt in zip(params["layers"], cfg.layer_types()):
        if max_len is None:
            x, _ = blocks.layer_forward(lp, x, cfg=cfg, layer_type=lt)
        else:
            x, c = blocks.layer_prefill(lp, x, cfg=cfg, layer_type=lt,
                                        max_len=max_len)
            caches.append(c)
    return x, caches


def forward_hidden(params, cfg: ModelConfig, batch: Dict[str, Tensor]
                   ) -> Tuple[Tensor, Tensor, int]:
    """Embed and run the layers. Returns (hidden (B,S,D), aux_loss,
    text_offset); aux is 0 and the offset 0 (no MoE, no modality
    prefix)."""
    check_supported(cfg)
    x = _embed(params, cfg, batch["tokens"])
    h, _ = _run_layers(params, cfg, x)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return h, torch.zeros((), dtype=torch.float32, device=h.device), 0


def prefill_hidden(params, cfg: ModelConfig, tokens: Tensor, max_len: int
                   ) -> Tuple[Tensor, Params]:
    """:func:`forward_hidden` through ``blocks.layer_prefill``: (hidden,
    cache) with the cache as T decode steps would have left it."""
    check_supported(cfg)
    x = _embed(params, cfg, tokens)
    h, caches = _run_layers(params, cfg, x, max_len=max_len)
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
    for lp, lc, lt in zip(params["layers"], cache["layers"],
                          cfg.layer_types()):
        x, nc = blocks.layer_decode(lp, x, lc, index, cfg=cfg, layer_type=lt)
        new_layers.append(nc)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = softcap(logits_fn(params, cfg, h)[:, 0], cfg.logit_softcap)
    return logits, {"layers": new_layers}
