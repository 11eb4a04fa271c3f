"""GQA attention: full / sliding-window / chunked, softcap, RoPE, a
bidirectional prefix (the VLM's image), a q-chunked full-sequence path, a
position-tagged KV-cache decode path and encoder-decoder cross-attention
(the port's copy of ``repro/models/attention.py``). Plain tensor ops
(``einsum``, ``softmax``): the reference has no attention kernel.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import apply_rope, dense_init, softcap

Tensor = torch.Tensor
NEG_INF = -1e30
# one-token scores over caches longer than this run chunk by chunk
# (flash-style), as the reference's; read at call time, so tests can
# patch it
_DECODE_CHUNK = 1 << 20


def init_attn(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32
              ) -> Dict[str, Tensor]:
    d, h, kv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    return {
        "wq": dense_init(gen, (d, h, hd), dtype=dtype),
        "wk": dense_init(gen, (d, kv, hd), dtype=dtype),
        "wv": dense_init(gen, (d, kv, hd), dtype=dtype),
        "wo": dense_init(gen, (h, hd, d), scale=1.0 / math.sqrt(h * hd),
                         dtype=dtype),
    }


def _qkv(params, xq: Tensor, xkv: Tensor, cfg: ModelConfig):
    q = torch.einsum("btd,dhk->bthk", xq, params["wq"])
    k = torch.einsum("bsd,dhk->bshk", xkv, params["wk"])
    v = torch.einsum("bsd,dhk->bshk", xkv, params["wv"])
    return q, k, v


class Heads(NamedTuple):
    """One self-attention's projections after RoPE: q (B, T, Hq, hd) of
    the heads this rank computes, k / v (B, T, KVq, hd) of the KV heads
    those read, kc / vc those the cache stores (every KV head, or this
    rank's where the cache is cut over ``model``), and whether ``wo``'s
    product is a partial sum over ``model``."""
    q: Tensor
    k: Tensor
    v: Tensor
    kc: Tensor
    vc: Tensor
    partial: bool
    kv_at: int = 0        # k's first KV head among kc's


def _kv_part(params, name: str, x: Tensor, tp) -> Tuple[Tensor, bool]:
    """(``name``'s product, whether it holds this rank's KV heads only):
    column-parallel over KV heads gives this rank's heads; row-parallel
    over D (the heads do not divide ``model``), the partial products
    summed over ``model``, every head; a whole leaf, every head."""
    w = params[name]
    d = tp.dim(name)
    if d is None or d == 1:
        return torch.einsum("bsd,dhk->bshk", x, w), d == 1
    if d == 0:
        n = w.shape[0]
        xs = x[..., tp.model.rank * n:(tp.model.rank + 1) * n]
        return tp.psum(torch.einsum("bsd,dhk->bshk", xs, w)), False
    raise NotImplementedError(f"attention: {name} cut over 'model' on dim "
                              f"{d} (head_dim) is not computed")


def _heads(params, x: Tensor, cfg: ModelConfig, positions: Tensor,
           tp=None) -> Heads:
    """Self-attention's projections of x (B, T, D) at ``positions``, with
    RoPE. Over a mesh, q is this rank's heads (``wq`` column-parallel
    over heads, ``wo`` row-parallel; both whole: every head); k / v for
    the attention are the KV heads of those, kc / vc the heads the
    cache holds. A placement not computed here raises, naming the leaf
    and the dim."""
    if tp is None or tp.model.size == 1:
        q, k, v = _qkv(params, x, x, cfg)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        return Heads(q, k, v, k, v, False)
    qd, od = tp.dim("wq"), tp.dim("wo")
    if (qd, od) not in ((None, None), (1, 0)):
        bad, d = ("wq", qd) if qd != 1 else ("wo", od)
        raise NotImplementedError(
            f"attention: {bad} cut over 'model' on dim {d}; the mesh steps "
            f"compute wq cut on its heads (dim 1) with wo on its (dim 0), "
            f"or both whole")
    kv, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    m = tp.model
    q = apply_rope(torch.einsum("btd,dhk->bthk", x, params["wq"]),
                   positions, cfg.rope_theta)
    hl = q.shape[2]
    h0 = m.rank * hl if qd == 1 else 0
    if hl % g == 0:
        kv0, kvn = h0 // g, hl // g
    elif g % hl == 0:
        kv0, kvn = h0 // g, 1
    else:
        raise NotImplementedError(
            f"attention: wq's {hl} heads a rank split the KV groups of {g} "
            f"heads unevenly")
    cut = None if tp.cspecs is None else tp.cache_dim("k", "model")
    if cut not in (None, 2):
        raise NotImplementedError(
            f"attention: the cache's k cut over 'model' on dim {cut} "
            f"(head_dim: the KV heads do not divide 'model') is not "
            f"computed")
    (k, local), (v, v_local) = (_kv_part(params, n, x, tp)
                                for n in ("wk", "wv"))
    if local != v_local or (local and qd is None):
        raise NotImplementedError(
            f"attention: wk / wv cut over 'model' on dims {tp.dim('wk')} / "
            f"{tp.dim('wv')} beside wq's {qd}")
    k = apply_rope(k, positions, cfg.rope_theta)
    kvm = kv // m.size
    if local:                       # this rank's KV heads: kv0.. kv0 + kvn
        kc, vc = k, v
        if cut != 2:                # the cache holds every KV head
            kc, vc = tp.gather(torch.stack((k, v)), 3).unbind(0)
    else:
        kc, vc = k, v
        if cut == 2:
            kc, vc = (t[:, :, m.rank * kvm:(m.rank + 1) * kvm] for t in (k, v))
        k, v = k[:, :, kv0:kv0 + kvn], v[:, :, kv0:kv0 + kvn]
    return Heads(q, k, v, kc, vc, qd == 1, 0 if cut == 2 else kv0)


def _sdpa(q: Tensor, k: Tensor, v: Tensor, mask: Optional[Tensor],
          attn_cap: float) -> Tensor:
    """q: (B,T,KV,G,hd) k/v: (B,S,KV,hd) mask: broadcastable (B,1,1,T,S),
    or None for no mask (cross-attention). Returns (B,T,KV,G,hd)."""
    hd = q.shape[-1]
    scores = torch.einsum("btkgh,bskh->bkgts", q, k) / math.sqrt(hd)
    scores = softcap(scores.to(torch.float32), attn_cap)
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgts,bskh->btkgh", p, v)


def _band_mask(qpos: Tensor, kpos: Tensor, layer_type: str,
               cfg: ModelConfig, prefix_len: int = 0) -> Tensor:
    """(T, S) boolean mask for self-attention given absolute positions;
    with ``prefix_len`` P the first P positions also see each other both
    ways (the VLM's image prefix, the encoder's whole input)."""
    qp, kp = qpos[:, None], kpos[None, :]
    causal = kp <= qp
    if layer_type == "L":
        m = causal & (kp > qp - cfg.window)
    elif layer_type == "C":
        m = causal & (kp // cfg.chunk == qp // cfg.chunk)
    else:
        m = causal
    if prefix_len > 0:
        m = m | ((kp < prefix_len) & (qp < prefix_len))
    return m


def _attn_seq(params, x: Tensor, cfg: ModelConfig, layer_type: str,
              q_chunk: int, prefix_len: int = 0, tp=None
              ) -> Tuple[Tensor, Tensor, Tensor]:
    """Full-sequence self-attention over positions 0..T-1 (the only
    positions the reference's ``forward_hidden`` passes), the first
    ``prefix_len`` bidirectional; returns (y, k, v) with k after RoPE
    (over a mesh, k and v hold the heads the cache stores: see
    :func:`_heads`).

    Loops over query chunks so the score block held live is
    (B, H, q_chunk, S); for "L"/"C" layers keys are sliced to the
    reachable band, so compute is O(T·window) rather than O(T²). The
    padded queries of a ragged last chunk carry position -1, which the
    prefix term lets through, so the mask drops them after it."""
    b, t, _ = x.shape
    positions = torch.arange(t, device=x.device)
    hs = _heads(params, x, cfg, positions, tp)
    q, k, v = hs.q, hs.k, hs.v
    kvh = k.shape[2]
    q = q.reshape(b, t, kvh, hs.q.shape[2] // kvh, -1)

    q_chunk = min(q_chunk, t)
    pad = (-t) % q_chunk                  # pad queries to a multiple
    qpos_all = positions
    if pad:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, 0, 0, pad))
        qpos_all = torch.cat([positions, positions.new_full((pad,), -1)])
    n_blocks = q.shape[1] // q_chunk

    # reachable-key band size for local/chunked layers (static)
    if layer_type == "L":
        band = min(t, cfg.window + q_chunk)
    elif layer_type == "C":
        band = min(t, ((cfg.chunk + q_chunk - 1) // cfg.chunk) * cfg.chunk)
    else:
        band = t

    outs = []
    for i in range(n_blocks):
        qi = q[:, i * q_chunk:(i + 1) * q_chunk]
        qp = qpos_all[i * q_chunk:(i + 1) * q_chunk]
        if band < t:
            # keys of the band ending at this q block's last position
            end = min((i + 1) * q_chunk, t)
            start = min(max(end - band, 0), t - band)
            ki, vi = k[:, start:start + band], v[:, start:start + band]
            kp = start + torch.arange(band, device=x.device)
        else:
            ki, vi, kp = k, v, positions
        m = _band_mask(qp, kp, layer_type, cfg, prefix_len)
        m = m & (qp[:, None] >= 0)
        outs.append(_sdpa(qi, ki, vi, m[None, None, None], cfg.attn_softcap))
    out = torch.cat(outs, dim=1).reshape(b, n_blocks * q_chunk,
                                         hs.q.shape[2], -1)[:, :t]
    y = torch.einsum("bthk,hkd->btd", out, params["wo"])
    return (tp.psum(y) if hs.partial else y), hs.kc, hs.vc


def attn_forward(params, x: Tensor, *, cfg: ModelConfig, layer_type: str,
                 prefix_len: int = 0, q_chunk: int = 1024, tp=None
                 ) -> Tensor:
    """Full-sequence self-attention (train / prefill) over positions
    0..T-1, the first ``prefix_len`` bidirectional. x: (B, T, D). The
    reference's ``positions`` argument is always arange(T) on its paths,
    so the port has none. ``tp``: this layer's place on a mesh
    (``models/parallel.py``), or ``None``."""
    return _attn_seq(params, x, cfg, layer_type, q_chunk, prefix_len,
                     tp)[0]


def cross_attn_forward(params, x: Tensor, memory: Tensor, *,
                       cfg: ModelConfig) -> Tensor:
    """Encoder-decoder cross-attention: the queries of x (B, T, D) over
    the keys and values of ``memory`` (B, F, D); no mask, no RoPE, no
    softcap (the reference passes 0.0, not ``cfg.attn_softcap``)."""
    b, t, _ = x.shape
    kvh, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    q, k, v = _qkv(params, x, memory, cfg)
    q = q.reshape(b, t, kvh, g, -1)
    out = _sdpa(q, k, v, None, 0.0).reshape(b, t, cfg.n_heads, -1)
    return torch.einsum("bthk,hkd->btd", out, params["wo"])


def attn_prefill(params, x: Tensor, *, cfg: ModelConfig, layer_type: str,
                 max_len: int, q_chunk: int = 1024, tp=None
                 ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """:func:`attn_forward` over positions 0..T-1 that also returns the
    decode cache: k (after RoPE) and v of the last min(T, cache_len)
    positions p at slot p % cache_len, ``pos`` = p there and -1 in the
    empty slots — what T decode steps from an empty cache leave. Over a
    mesh, this rank's shard of it (``tp.cspecs``): its rows, its KV heads
    where the cache is cut over ``model``, its slot range where the
    sequence is cut over the data axes (``pos`` whole)."""
    y, k, v = _attn_seq(params, x, cfg, layer_type, q_chunk, tp=tp)
    b, t = x.shape[:2]
    s = cache_len(cfg, layer_type, max_len)
    lo, n = _slot_range(s, tp)
    if tp is None:
        cache = init_attn_cache(cfg, layer_type, b, max_len, dtype=k.dtype,
                                device=x.device)
    else:
        cache = {"k": k.new_zeros((b, n) + tuple(k.shape[2:])),
                 "v": v.new_zeros((b, n) + tuple(v.shape[2:])),
                 "pos": torch.full((s,), -1, dtype=torch.int32,
                                   device=x.device)}
    p = torch.arange(max(t - s, 0), t, device=x.device)
    slots = p % s
    cache["pos"][slots] = p.to(torch.int32)
    if n < s:                                 # this rank's slots only
        mine = (slots >= lo) & (slots < lo + n)
        p, slots = p[mine], slots[mine] - lo
    cache["k"][:, slots] = k[:, p]
    cache["v"][:, slots] = v[:, p]
    return y, cache


def _slot_range(s: int, tp) -> Tuple[int, int]:
    """(first slot, slots) of a cache of ``s`` slots this rank holds: all
    of them, or a contiguous range where the cache's sequence is cut over
    the data axes (distributed-cache decode)."""
    if tp is None or tp.cspecs is None or tp.cache_dim("k", "data") != 1:
        return 0, s
    n = s // tp.data.size
    return tp.data.rank * n, n


# ---------------------------------------------------------------------------
# Decode path: position-tagged KV cache valid for full / window / chunk.

def cache_len(cfg: ModelConfig, layer_type: str, max_len: int) -> int:
    if layer_type == "L":
        return min(max_len, cfg.window)
    if layer_type == "C":
        return min(max_len, cfg.chunk)
    return max_len


def init_attn_cache(cfg: ModelConfig, layer_type: str, batch: int,
                    max_len: int, dtype=torch.float32, device=None
                    ) -> Dict[str, Tensor]:
    s = cache_len(cfg, layer_type, max_len)
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros((batch, s, kv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, s, kv, hd), dtype=dtype, device=device),
        # absolute position per slot
        "pos": torch.full((s,), -1, dtype=torch.int32, device=device),
    }


def attn_decode(params, x: Tensor, cache: Dict[str, Tensor], index: int, *,
                cfg: ModelConfig, layer_type: str, tp=None
                ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One-token decode at absolute position ``index``; the cache slot is
    index mod the cache length. Writes the new k, v and position into
    ``cache`` in place (no copy of the cache a step) and returns it.

    Over a mesh (``tp``), this rank's heads attend over its shard of the
    cache: where the sequence is cut over the data axes, only the rank
    holding the slot writes it, and the ranks' partial softmax triples
    (max, denominator, output) in fp32 are combined over the data axes."""
    b = x.shape[0]
    s = cache["pos"].shape[0]
    hs = _heads(params, x, cfg, torch.full((1, 1), index, device=x.device),
                tp)
    kvn = hs.k.shape[2]
    q = hs.q.reshape(b, 1, kvn, hs.q.shape[2] // kvn, -1)

    slot = index % s
    lo, n = _slot_range(s, tp)
    if lo <= slot < lo + n:
        cache["k"][:, slot - lo] = hs.kc[:, 0]
        cache["v"][:, slot - lo] = hs.vc[:, 0]
    cache["pos"][slot] = index
    cpos = cache["pos"][lo:lo + n]

    if layer_type == "L":
        lower = index - cfg.window + 1
    elif layer_type == "C":
        lower = (index // cfg.chunk) * cfg.chunk
    else:
        lower = 0
    valid = (cpos >= lower) & (cpos <= index) & (cpos >= 0)       # (n,)
    ck, cv = cache["k"], cache["v"]
    if kvn != ck.shape[2]:                    # this rank's heads' view
        ck = ck[:, :, hs.kv_at:hs.kv_at + kvn]
        cv = cv[:, :, hs.kv_at:hs.kv_at + kvn]
    if n == s:
        out = _decode_attn(q, ck, cv, valid, cfg.attn_softcap)
    else:
        m, l, o = _decode_partial(q, ck, cv, valid, cfg.attn_softcap)
        mg = tp.dmax(m.clone())
        corr = torch.exp(m - mg)
        l = tp.dsum(l * corr)
        o = tp.dsum(o * corr[..., None])
        out = _finish(o, l, q.dtype)
    out = out.reshape(b, 1, hs.q.shape[2], -1)
    y = torch.einsum("bthk,hkd->btd", out, params["wo"])
    return (tp.psum(y) if hs.partial else y), cache


def _decode_attn(q: Tensor, k: Tensor, v: Tensor, valid: Tensor,
                 attn_cap: float) -> Tensor:
    """One-token attention over the cache. q: (B,1,KV,G,hd); k/v:
    (B,S,KV,hd); valid: (S,). Returns (B,1,KV,G,hd).

    A cache of more than ``_DECODE_CHUNK`` slots is scanned in chunks of
    that many (:func:`_decode_partial`), so the live scores are
    (B, KV, G, 1, chunk) instead of (..., S)
    (``repro/models/attention.py:207-256``)."""
    if k.shape[1] <= _DECODE_CHUNK:
        return _sdpa(q, k, v, valid[None, None, None, None, :], attn_cap)
    m, l, o = _decode_partial(q, k, v, valid, attn_cap)
    return _finish(o, l, q.dtype)


def _decode_partial(q: Tensor, k: Tensor, v: Tensor, valid: Tensor,
                    attn_cap: float) -> Tuple[Tensor, Tensor, Tensor]:
    """The running (max, denominator, output) triple in fp32 of one-token
    attention over the slots of k / v, ``_DECODE_CHUNK`` at a time:
    (B,KV,G,1), (B,KV,G,1), (B,KV,G,1,hd). The chunks are views of the
    cache and the last one is ragged: the reference pads k and v to whole
    chunks, but a padded slot is invalid and adds exactly 0 once any slot
    is valid (``attn_decode``'s own slot always is), so the copy is left
    out. A wholly invalid chunk before the first valid one adds exp(0)
    terms that the next valid chunk's correction exp(-1e30 - m) = 0
    wipes, as in the reference; so does a rank's wholly invalid range
    when the ranks' triples are combined."""
    s = k.shape[1]
    c = _DECODE_CHUNK
    b, _, kvh, hd = k.shape
    g = q.shape[3]
    hd_scale = 1.0 / math.sqrt(hd)
    f32 = dict(dtype=torch.float32, device=q.device)
    m = torch.full((b, kvh, g, 1), NEG_INF, **f32)
    l = torch.zeros((b, kvh, g, 1), **f32)
    o = torch.zeros((b, kvh, g, 1, hd), **f32)
    for start in range(0, s, c):
        ki, vi = k[:, start:start + c], v[:, start:start + c]
        sc = torch.einsum("btkgh,bskh->bkgts", q, ki) * hd_scale
        sc = softcap(sc.to(torch.float32), attn_cap)
        sc = torch.where(valid[start:start + c], sc, NEG_INF)
        m_new = torch.maximum(m, torch.amax(sc, dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        o = o * corr[..., None] + torch.einsum(
            "bkgts,bskh->bkgth", p.to(q.dtype), vi).to(torch.float32)
        m = m_new
    return m, l, o


def _finish(o: Tensor, l: Tensor, dtype) -> Tensor:
    """o / l of a triple, (B,KV,G,1,hd) -> (B,1,KV,G,hd) in ``dtype``."""
    out = o / torch.clamp(l[..., None], min=1e-30)
    return torch.movedim(out, 3, 1).to(dtype)


def init_cross_cache(params, memory: Tensor, cfg: ModelConfig
                     ) -> Dict[str, Tensor]:
    """Cross-attention keys and values of the encoder's output ``memory``
    (B, F, D), computed once: {"k", "v"} of (B, F, KV, hd)."""
    return {"k": torch.einsum("bsd,dhk->bshk", memory, params["wk"]),
            "v": torch.einsum("bsd,dhk->bshk", memory, params["wv"])}


def cross_attn_decode(params, x: Tensor, cache: Dict[str, Tensor], *,
                      cfg: ModelConfig) -> Tensor:
    """One-token cross-attention of x (B, 1, D) over the cached encoder
    keys and values (:func:`init_cross_cache`); no mask, no softcap."""
    b = x.shape[0]
    kvh, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    q = torch.einsum("btd,dhk->bthk", x, params["wq"]).reshape(
        b, 1, kvh, g, -1)
    out = _sdpa(q, cache["k"], cache["v"], None, 0.0).reshape(
        b, 1, cfg.n_heads, -1)
    return torch.einsum("bthk,hkd->btd", out, params["wo"])
