"""Decoder and encoder-decoder transformer assembled from blocks, with
the stub modality inputs (a VLM's patch prefix, an audio encoder's
frames), the chunked LM loss, a prefill that fills the decode cache and a
one-token decode step (the port's copy of ``repro/models/transformer.py``).

The reference stacks the layers of repeated pattern cycles into
``scanned`` groups for ``lax.scan``, and the encoder's layers into one
stack; PyTorch loops in Python, so the port keeps lists,
``params["layers"][i]``, ``params["encoder"]["layers"][i]`` and
``cache["layers"][i]`` (``repro_torch.convert`` unstacks).
"""
from __future__ import annotations

import math
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks
from repro_torch.models.attention import init_cross_cache
from repro_torch.models.common import (chunked_cross_entropy, dense_init,
                                       remat, rms_norm, sinusoid_at,
                                       sinusoidal_positions, softcap)
from repro_torch.tree import tree_leaves

Tensor = torch.Tensor
Params = Dict[str, Any]


def layer_signature(cfg: ModelConfig, layer_idx: int) -> Tuple[str, bool]:
    """(block type, whether the FFN is MoE) of layer ``layer_idx``."""
    return cfg.layer_types()[layer_idx], cfg.is_moe_layer(layer_idx)


def layer_period(cfg: ModelConfig) -> int:
    """The reference's period of the per-layer signature
    (``repro/models/transformer.py:_p_eff``): it stacks layers [0, r·p),
    r = num_layers // p, into p ``scanned`` groups (layer i in group
    i % p, at depth i // p) and keeps the rest as its ``tail``."""
    p = len(cfg.block_pattern)
    if cfg.n_experts > 0 and cfg.moe_every > 1:
        p = math.lcm(p, cfg.moe_every)
    return min(p, cfg.num_layers)


def _sinusoidal(cfg: ModelConfig) -> bool:
    """Whether the model adds fixed sinusoidal positions to its input
    (no RoPE, and not an attention-free SSM)."""
    return cfg.rope_theta <= 0 and cfg.family != "ssm"


# ---------------------------------------------------------------------------
# init

def init_params(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
                place: Optional[Callable[[Tuple, Any], Any]] = None
                ) -> Params:
    """Random weights drawn from ``gen`` on its device, layer by layer
    (with cross-attention in an encoder-decoder's), then the embedding,
    the LM head when untied, and an encoder-decoder's encoder: "A"
    layers with a dense FFN and no cross-attention, and its final
    norm. ``place(path, subtree)``, when given, takes each layer as soon
    as it is drawn (path ``("layers", i)``), then each other top-level
    entry (``("embed",)``, ...), and its result is kept instead: the
    draws, their order and the generator are the same."""
    d, v = cfg.d_model, cfg.vocab_size
    cross = cfg.is_encdec
    keep = place or (lambda path, x: x)
    layers = [keep(("layers", i),
                   blocks.init_layer(gen, cfg, *layer_signature(cfg, i),
                                     dtype, cross=cross))
              for i in range(cfg.num_layers)]
    params: Params = {
        "embed": keep(("embed",), dense_init(gen, (v, d), scale=0.02,
                                             dtype=dtype)),
        "layers": layers,
        "final_norm": keep(("final_norm",),
                           torch.zeros(d, dtype=dtype, device=gen.device)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = keep(("lm_head",),
                                 dense_init(gen, (d, v), dtype=dtype))
    if cross:
        params["encoder"] = keep(("encoder",), {
            "layers": [blocks.init_layer(gen, cfg, "A", False, dtype)
                       for _ in range(cfg.enc_layers)],
            "final_norm": torch.zeros(d, dtype=dtype, device=gen.device)})
    return params


class _MetaGenerator(torch.Generator):
    """A CPU generator that reports the meta device, so the init functions
    (which allocate on ``gen.device``) build shapes only: a meta tensor
    takes the draws' arguments and draws nothing."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def param_shapes(cfg: ModelConfig, dtype=torch.float32) -> Params:
    """:func:`init_params`'s tree on the meta device: the same keys, shapes
    and dtypes, no storage (the reference's ``jax.eval_shape`` of
    ``Model.init``). llama4-maverick's ~394 B weights cost nothing."""
    return init_params(_MetaGenerator(), cfg, dtype)


def param_count(params: Params) -> int:
    """The number of weights actually held (the config's analytic
    ``param_count`` undercounts the RG-LRU and RWKV6 layers and leaves
    out ``final_norm``)."""
    return sum(x.numel() for x in tree_leaves(params))


# ---------------------------------------------------------------------------
# forward (prefill)

def _embed(params, cfg: ModelConfig, tokens: Tensor, tp=None) -> Tensor:
    """The tokens' embeddings, scaled where the model scales them. Over a
    mesh (``tp``), an embedding cut on the vocabulary is looked up where
    this rank holds the row (zeros elsewhere) and summed over ``model``;
    one cut on D is looked up and all-gathered."""
    w = params["embed"]
    d = None if tp is None else tp.dim("embed")
    if d is None:
        x = w[tokens]
    elif d == 0:
        n = w.shape[0]
        local = tokens - tp.model.rank * n
        inside = (local >= 0) & (local < n)
        x = torch.where(inside[..., None], w[local.clamp(0, n - 1)],
                        torch.zeros((), dtype=w.dtype, device=w.device))
        x = tp.psum(x)
    else:
        x = tp.gather(w[tokens], -1)
    if cfg.emb_scale:
        # the reference scales by sqrt(d_model) cast to the working dtype
        # first (50.5, not 50.596, in bf16 at d_model 2560)
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype).item()
    return x


def logits_fn(params, cfg: ModelConfig, h: Tensor, tp=None) -> Tensor:
    """The LM head's logits of h (..., D). Over a mesh (``tp``), a head
    cut on the vocabulary gives this rank's columns, all-gathered over
    ``model`` (the reference's vocab-parallel logits); one cut on D
    partial products, summed over it."""
    name = "embed" if cfg.tie_embeddings else "lm_head"
    w = params[name].T if cfg.tie_embeddings else params[name]  # (D, V)
    d = None if tp is None else tp.dim(name)
    if d is None:
        return h @ w
    if d == (0 if cfg.tie_embeddings else 1):
        return tp.gather(h @ w, -1)
    n = w.shape[0]
    return tp.psum(h[..., tp.model.rank * n:(tp.model.rank + 1) * n] @ w)


def unshard_head(params, tp):
    """``params`` with its embedding and LM head whole along the data axes
    (``fsdp``), as :func:`forward_hidden` and :func:`prefill_hidden` take
    them over a mesh; the layers' leaves are gathered a layer at a
    time."""
    if tp is None or tp.data.size == 1:
        return params
    top = {k: params[k] for k in ("embed", "lm_head") if k in params}
    return dict(params, **tp.unshard(top))


def _run_layers(params, cfg: ModelConfig, x: Tensor, *,
                max_len: Optional[int] = None, prefix_len: int = 0,
                memory: Optional[Tensor] = None, tp=None
                ) -> Tuple[Tensor, Tensor, Optional[List[Params]]]:
    """Apply all decoder layers over positions 0..T-1, the first
    ``prefix_len`` bidirectional, cross-attending to ``memory``:
    (hidden, the sum of the layers' aux losses, caches); with ``max_len``
    also each layer's decode cache (and the aux 0: prefill drops it).
    Without it and with ``cfg.remat``, each layer is rematerialized in
    the backward (the reference's ``jax.checkpoint`` per layer): only the
    layer boundaries are saved. Over a mesh (``tp``), each layer's leaves
    cut over the data axes are gathered just before it runs."""
    caches = [] if max_len is not None else None
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(params["layers"]):
        lt, moe = layer_signature(cfg, i)
        ltp = _layer_tp(tp, i)
        if ltp is not None:
            lp = ltp.unshard(lp)
        if max_len is None:
            fwd = partial(blocks.layer_forward, cfg=cfg, layer_type=lt,
                          is_moe=moe, prefix_len=prefix_len, memory=memory,
                          tp=ltp)
            x, a = remat(fwd, lp, x) if cfg.remat else fwd(lp, x)
            aux = aux + a
        else:
            x, c = blocks.layer_prefill(lp, x, cfg=cfg, layer_type=lt,
                                        max_len=max_len, is_moe=moe,
                                        memory=memory, tp=ltp)
            caches.append(c)
    return x, aux, caches


def _layer_tp(tp, i: int):
    return None if tp is None else tp.sub("layers").sub(i)


def encode(params, cfg: ModelConfig, frames: Tensor, tp=None) -> Tensor:
    """Whisper-style encoder over stub frame embeddings (B, F, D), cast
    to the weights' dtype: sinusoidal positions, then "A" layers that
    attend over all F frames both ways, then the final RMS norm
    (gemma-style, as the reference's; not Whisper's LayerNorm). Over a
    mesh (``tp``, the model's), this rank's rows and its shards of the
    encoder's weights: a layer whose spec the reference gives its stack's
    layer dim (``Spec.layer``) is whole on every rank, and ``wq`` / ``wk``
    / ``wv`` cut on D compute every head on every rank."""
    enc = params["encoder"]
    f = frames.shape[1]
    x = frames.to(enc["final_norm"].dtype)
    x = x + sinusoidal_positions(f, cfg.d_model, x.device).to(x.dtype)
    etp = None if tp is None else tp.sub("encoder").sub("layers")
    for i, lp in enumerate(enc["layers"]):
        ltp = None if etp is None else etp.sub(i)
        if ltp is not None:
            lp = ltp.unshard(lp)
        x, _ = blocks.layer_forward(lp, x, cfg=cfg, layer_type="A",
                                    prefix_len=f, tp=ltp)
    return rms_norm(x, enc["final_norm"], cfg.norm_eps)


def forward_hidden(params, cfg: ModelConfig, batch: Dict[str, Tensor],
                   tp=None) -> Tuple[Tensor, Tensor, int]:
    """Embed the tokens (scaled) after a VLM's ``patches`` when the batch
    has them (cast, not scaled; they attend both ways), add sinusoidal
    positions over S where the model uses them, and run the layers (an
    encoder-decoder's against its encoded ``frames``). Returns (hidden
    (B,S,D), aux_loss, text_offset): the MoE layers' aux losses summed (0
    without MoE), the offset the prefix length P (0 without patches).
    Over a mesh (``tp``), ``batch`` holds this rank's rows and ``params``
    its shards, the embedding and head whole along the data axes
    (:func:`unshard_head`)."""
    x = _embed(params, cfg, batch["tokens"], tp)
    prefix_len, memory = 0, None
    if cfg.vis_tokens > 0 and "patches" in batch:
        patches = batch["patches"]
        x = torch.cat([patches.to(x.dtype), x], dim=1)
        prefix_len = patches.shape[1]
    if cfg.is_encdec:
        memory = encode(params, cfg, batch["frames"], tp)
    if _sinusoidal(cfg):
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                     x.device).to(x.dtype)
    h, aux, _ = _run_layers(params, cfg, x, prefix_len=prefix_len,
                            memory=memory, tp=tp)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return h, aux, prefix_len


def loss_fn(params, cfg: ModelConfig, batch: Dict[str, Tensor],
            loss_chunk: int = 512) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Next-token LM loss (+ the MoE aux). ``batch``: tokens
    (B, S_text), optional labels and mask (default: the tokens shifted
    left, the last position masked), optional patches / frames for a VLM
    / an encoder-decoder; the patch prefix's positions carry no loss."""
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


def prefill_hidden(params, cfg: ModelConfig, tokens: Tensor, max_len: int,
                   memory: Optional[Tensor] = None, tp=None
                   ) -> Tuple[Tensor, Params]:
    """:func:`forward_hidden` of the text alone through
    ``blocks.layer_prefill``, cross-attending to ``memory`` (the encoded
    frames): (hidden, cache) with the cache as T decode steps from
    ``init_cache(..., memory=memory)`` would have left it; over a mesh
    (``tp``), this rank's rows and its shard of the cache, from params as
    :func:`forward_hidden` takes them."""
    x = _embed(params, cfg, tokens, tp)
    if _sinusoidal(cfg):
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                     x.device).to(x.dtype)
    h, _, caches = _run_layers(params, cfg, x, max_len=max_len,
                               memory=memory, tp=tp)
    return rms_norm(h, params["final_norm"], cfg.norm_eps), {"layers": caches}


# ---------------------------------------------------------------------------
# decode

def init_cache(params, cfg: ModelConfig, batch: int, max_len: int,
               memory: Optional[Tensor] = None) -> Params:
    """An empty decode cache in the weights' dtype on their device (the
    decode path computes in one dtype, so the cache takes the weights');
    an encoder-decoder's layers hold ``memory``'s cross-attention keys
    and values, or zeros of ``cfg.enc_frames`` frames without it. (Over
    a mesh: ``MeshModel.init_cache``.)"""
    emb = params["embed"]
    cross = cfg.is_encdec
    layers = [blocks.init_layer_cache(cfg, lt, batch, max_len, emb.dtype,
                                      emb.device, cross=cross)
              for lt in cfg.layer_types()]
    if cross and memory is not None:
        for lc, lp in zip(layers, params["layers"]):
            lc["cross"] = {k: v.to(emb.dtype) for k, v in
                           init_cross_cache(lp["cross"], memory, cfg).items()}
    return {"layers": layers}


def decode_step(params, cfg: ModelConfig, cache: Params, token: Tensor,
                index: int, tp=None) -> Tuple[Tensor, Params]:
    """One decode step. token: (B,) integer; index: the absolute position
    (a Python int), whose sinusoid is added where the model uses them.
    Returns (logits (B, V), new cache); attention caches are updated in
    place. Over a mesh (``tp``), this rank's rows, its shards of the
    weights and of the cache; the logits whole along the vocabulary."""
    params = unshard_head(params, tp)
    x = _embed(params, cfg, token[:, None], tp)
    if _sinusoidal(cfg):
        pos = torch.full((1,), index, device=x.device)
        x = x + sinusoid_at(pos, cfg.d_model).to(x.dtype)
    new_layers = []
    for i, (lp, lc) in enumerate(zip(params["layers"], cache["layers"])):
        lt, moe = layer_signature(cfg, i)
        ltp = _layer_tp(tp, i)
        if ltp is not None:
            lp = ltp.unshard(lp)
        x, nc = blocks.layer_decode(lp, x, lc, index, cfg=cfg, layer_type=lt,
                                    is_moe=moe, tp=ltp)
        new_layers.append(nc)
    h = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = softcap(logits_fn(params, cfg, h, tp)[:, 0], cfg.logit_softcap)
    return logits, {"layers": new_layers}
