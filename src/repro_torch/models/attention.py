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
    the heads this rank computes, from head ``h0``; k / v (B, T, KVq, hd)
    of the KV heads those read; kc / vc what the cache stores (every KV
    head, or this rank's where the cache is cut over ``model`` on the
    heads, or every head's slice of head_dim where it is cut on
    head_dim: ``hd_cut``)."""
    q: Tensor
    k: Tensor
    v: Tensor
    kc: Tensor
    vc: Tensor
    h0: int = 0
    kv_at: int = 0        # k's first KV head among kc's
    hd_cut: bool = False


def _kv_part(params, name: str, x: Tensor, tp) -> Tuple[Tensor, bool]:
    """(``name``'s product, whether it holds this rank's heads only):
    column-parallel over the heads gives this rank's heads; row-parallel
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


def _q_block(q: Tensor, local: bool, cfg: ModelConfig, tp, cut
             ) -> Tuple[Tensor, int, int, int]:
    """(q, its first head, the first KV head it reads, how many) of the
    heads this rank computes: its own where ``wq`` is cut on them (or
    where the cache holds only its KV heads), else every head."""
    h, g, m = cfg.n_heads, cfg.n_heads // cfg.n_kv_heads, tp.model
    hl = q.shape[2]
    h0 = m.rank * hl if local else 0
    if cut == 2 and not local:     # the cache holds this rank's KV heads
        hl = h // m.size
        h0 = m.rank * hl
        q = q[:, :, h0:h0 + hl]
    if hl % g == 0:
        return q, h0, h0 // g, hl // g
    if g % hl == 0:
        return q, h0, h0 // g, 1
    raise NotImplementedError(
        f"attention: wq's {hl} heads a rank split the KV groups of {g} "
        f"heads unevenly")


def _kv_heads(params, q: Tensor, local_q: bool, xkv: Tensor,
              cfg: ModelConfig, tp, rope=None) -> Heads:
    """:class:`Heads` of the queries ``q`` (``local_q``: this rank's heads)
    over the keys and values of ``xkv``, ``rope`` applied to the keys."""
    kv, m = cfg.n_kv_heads, tp.model
    cut = None if tp.cspecs is None else tp.cache_dim("k", "model")
    if cut not in (None, 2, 3):
        raise NotImplementedError(
            f"attention: the cache's k cut over 'model' on dim {cut} is not "
            f"computed")
    q, h0, kv0, kvn = _q_block(q, local_q, cfg, tp, cut)
    (k, local), (v, v_local) = (_kv_part(params, n, xkv, tp)
                                for n in ("wk", "wv"))
    kvm = kv // m.size
    if local != v_local or (local and (kv0, kvn) != (m.rank * kvm, kvm)):
        raise NotImplementedError(
            f"attention: wk / wv cut over 'model' on dims {tp.dim('wk')} / "
            f"{tp.dim('wv')} beside wq's {tp.dim('wq')}")
    if rope is not None:
        k = rope(k)
    kc, vc = k, v
    if local:                       # this rank's KV heads: kv0.. kv0 + kvn
        if cut is None and tp.cspecs is not None:   # a cache of every head
            kc, vc = tp.gather(torch.stack((k, v)), 3).unbind(0)
    else:
        if cut == 2:
            kc, vc = (t[:, :, m.rank * kvm:(m.rank + 1) * kvm]
                      for t in (k, v))
        elif cut == 3:              # this rank's slice of head_dim
            n = k.shape[3] // m.size
            kc, vc = (t[..., m.rank * n:(m.rank + 1) * n] for t in (k, v))
        k, v = k[:, :, kv0:kv0 + kvn], v[:, :, kv0:kv0 + kvn]
    at = kv0 - (m.rank * kvm if cut == 2 else 0)
    return Heads(q, k, v, kc, vc, h0, at, cut == 3)


def _q_proj(params, x: Tensor, tp) -> Tuple[Tensor, bool]:
    """(the queries of x, whether they are this rank's heads only):
    ``wq`` cut on its heads, column-parallel; cut on D, row-parallel
    (every head, summed over ``model``); whole, every head. ``wq`` cut
    on head_dim raises."""
    d = tp.dim("wq")
    if d == 2:
        raise NotImplementedError(
            "attention: wq cut over 'model' on dim 2 (head_dim); the mesh "
            "steps compute wq cut on its heads (dim 1) or on D (dim 0), or "
            "whole")
    return _kv_part(params, "wq", x, tp)


def _heads(params, x: Tensor, cfg: ModelConfig, positions: Tensor,
           tp=None) -> Heads:
    """Self-attention's projections of x (B, T, D) at ``positions``, with
    RoPE. Over a mesh, q is this rank's heads where ``wq`` is cut on them
    (else every head: ``wq`` cut on D sums its partial products over
    ``model``); k / v for the attention are the KV heads of those, kc /
    vc what the cache holds. A placement not computed here raises,
    naming the leaf and the dim."""
    def rope(t):
        return apply_rope(t, positions, cfg.rope_theta)
    if tp is None or tp.model.size == 1:
        q, k, v = _qkv(params, x, x, cfg)
        q, k = rope(q), rope(k)
        return Heads(q, k, v, k, v)
    q, local = _q_proj(params, x, tp)
    return _kv_heads(params, rope(q), local, x, cfg, tp, rope)


def _project(params, out: Tensor, h0: int, cfg: ModelConfig, tp) -> Tensor:
    """``wo``'s product of out (B, T, Hq, hd), the heads from ``h0``: over
    a mesh, ``wo`` cut on its heads (or whole) takes this rank's heads'
    rows and sums over ``model``; cut on head_dim (an encoder stack whose
    layers do not divide ``model``), every head's output on this rank's
    slice of head_dim, summed over ``model``; cut on its output D, every
    head's output (gathered where this rank holds its own heads only)
    gives this rank's columns, all-gathered; whole with every head, no
    collective."""
    w = params["wo"]
    if tp is None or tp.model.size == 1:
        return torch.einsum("bthk,hkd->btd", out, w)
    d, hq, h = tp.dim("wo"), out.shape[2], cfg.n_heads
    if d == 2:
        if hq < h:
            out = tp.gather(out, 2)
        return tp.gather(torch.einsum("bthk,hkd->btd", out, w), -1)
    if d == 0:
        n = w.shape[0]
        lo = tp.model.rank * n
        if hq == h:
            out = out[:, :, lo:lo + n]
        elif (h0, hq) != (lo, n):
            raise NotImplementedError(
                f"attention: wo's heads {lo}..{lo + n} a rank beside the "
                f"queries' {h0}..{h0 + hq}")
        return tp.psum(torch.einsum("bthk,hkd->btd", out, w))
    if d == 1:      # on head_dim: every head's output on this rank's slice
        if hq < h:
            out = tp.gather(out, 2)
        n = w.shape[1]
        return tp.psum(torch.einsum(
            "bthk,hkd->btd",
            out[..., tp.model.rank * n:(tp.model.rank + 1) * n], w))
    if hq < h:
        return tp.psum(torch.einsum("bthk,hkd->btd", out, w[h0:h0 + hq]))
    return torch.einsum("bthk,hkd->btd", out, w)


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
    return _project(params, out, hs.h0, cfg, tp), hs.kc, hs.vc


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
                       cfg: ModelConfig, tp=None) -> Tensor:
    """Encoder-decoder cross-attention: the queries of x (B, T, D) over
    the keys and values of ``memory`` (B, F, D); no mask, no RoPE, no
    softcap (the reference passes 0.0, not ``cfg.attn_softcap``). Over a
    mesh (``tp``), as :func:`cross_attn_prefill`."""
    if tp is not None:
        return cross_attn_prefill(params, x, memory, cfg=cfg, tp=tp)[0]
    b, t, _ = x.shape
    kvh, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
    q, k, v = _qkv(params, x, memory, cfg)
    q = q.reshape(b, t, kvh, g, -1)
    out = _sdpa(q, k, v, None, 0.0).reshape(b, t, cfg.n_heads, -1)
    return torch.einsum("bthk,hkd->btd", out, params["wo"])


def _frames_cut(tp) -> bool:
    """Whether the cross cache cuts its frames over the data axes (batch
    1: each data rank keeps its frames' keys and values)."""
    return tp.cspecs is not None and tp.cache_dim("k", "data") == 1


def _cross_heads(params, x: Tensor, memory: Tensor, cfg: ModelConfig,
                 tp) -> Heads:
    """:class:`Heads` of cross-attention over a mesh: the queries of x,
    the keys and values of this rank's frames of ``memory`` (all of
    them unless the cache cuts them over the data axes)."""
    if _frames_cut(tp):
        n = memory.shape[1] // tp.data.size
        memory = memory[:, tp.data.rank * n:(tp.data.rank + 1) * n]
    q, local = _q_proj(params, x, tp)
    hs = _kv_heads(params, q, local, memory, cfg, tp)
    if hs.hd_cut:
        raise NotImplementedError(
            "cross-attention: the cross cache's k cut over 'model' on dim 3 "
            "(head_dim) is not computed")
    return hs


def _cross_attend(q: Tensor, k: Tensor, v: Tensor, tp) -> Tensor:
    """Cross-attention of q (B, T, KV, G, hd) over k / v: where the frames
    are cut over the data axes, each rank's partial softmax triple over
    its frames, combined as :func:`_combine` does."""
    if tp is None or not _frames_cut(tp):
        return _sdpa(q, k, v, None, 0.0)
    valid = torch.ones(k.shape[1], dtype=torch.bool, device=k.device)
    return _combine(tp, *_decode_partial(q, k, v, valid, 0.0), q.dtype)


def cross_attn_prefill(params, x: Tensor, memory: Tensor, *,
                       cfg: ModelConfig, tp=None
                       ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """(:func:`cross_attn_forward`, :func:`init_cross_cache`): the
    cross-attention of x over ``memory`` and memory's keys and values.
    Over a mesh (``tp``), this rank's heads (``wq`` cut on them; every
    head where it is cut on D or whole), and its frames where the cross
    cache cuts them over the data axes (the softmax triples combined over
    them); the keys and values are this rank's shard of the cross
    cache."""
    if tp is None:
        return (cross_attn_forward(params, x, memory, cfg=cfg),
                init_cross_cache(params, memory, cfg))
    b, t, _ = x.shape
    hs = _cross_heads(params, x, memory, cfg, tp)
    kvn = hs.k.shape[2]
    q = hs.q.reshape(b, t, kvn, hs.q.shape[2] // kvn, -1)
    out = _cross_attend(q, hs.k, hs.v, tp).reshape(b, t, hs.q.shape[2], -1)
    return (_project(params, out, hs.h0, cfg, tp),
            {"k": hs.kc, "v": hs.vc})


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
    (max, denominator, output) in fp32 are combined over the data axes;
    where head_dim is cut over ``model``, every rank scores every head
    on its slice of it, the partial scores summed over ``model`` before
    the softcap and softmax, and p·v gathered on head_dim."""
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
    hq = hs.q.shape[2]
    if hs.hd_cut:
        out = _decode_hd_cut(hs, ck, cv, valid, cfg, tp)
        out = out.reshape(b, 1, cfg.n_heads, -1)[:, :, hs.h0:hs.h0 + hq]
        return _project(params, out, hs.h0, cfg, tp), cache
    if kvn != ck.shape[2]:                    # this rank's heads' view
        ck = ck[:, :, hs.kv_at:hs.kv_at + kvn]
        cv = cv[:, :, hs.kv_at:hs.kv_at + kvn]
    if n == s:
        out = _decode_attn(q, ck, cv, valid, cfg.attn_softcap)
    else:
        out = _combine(tp, *_decode_partial(q, ck, cv, valid,
                                            cfg.attn_softcap), q.dtype)
    out = out.reshape(b, 1, hq, -1)
    return _project(params, out, hs.h0, cfg, tp), cache


def _combine(tp, m: Tensor, l: Tensor, o: Tensor, dtype) -> Tensor:
    """The data ranks' partial softmax triples (each over its share of
    the keys) combined: the max, then the corrected denominators and
    outputs summed; :func:`_finish`'s (B, T, KV, G, hd)."""
    mg = tp.dmax(m.clone())
    corr = torch.exp(m - mg)
    l = tp.dsum(l * corr)
    o = tp.dsum(o * corr[..., None])
    return _finish(o, l, dtype)


def _decode_hd_cut(hs: Heads, ck: Tensor, cv: Tensor, valid: Tensor,
                   cfg: ModelConfig, tp) -> Tensor:
    """One-token attention of every head over a cache holding this
    rank's slice of head_dim (B, S, KV, hd / model): q gathered to every
    head where it holds this rank's, the partial q·k scores summed over
    ``model`` in fp32 before the softcap and softmax, p·v on the slice
    gathered on head_dim. Returns (B, 1, KV, G, hd)."""
    q = hs.q
    if q.shape[2] < cfg.n_heads:
        q = tp.gather(q, 2)
    b, _, h, hd = q.shape
    kv = ck.shape[2]
    n = ck.shape[3]
    r = tp.model.rank
    q = q.reshape(b, 1, kv, h // kv, hd)[..., r * n:(r + 1) * n]
    sc = tp.psum(torch.einsum("btkgh,bskh->bkgts", q, ck).to(torch.float32))
    sc = softcap(sc / math.sqrt(hd), cfg.attn_softcap)
    sc = torch.where(valid, sc, NEG_INF)
    p = torch.softmax(sc, dim=-1).to(q.dtype)
    return tp.gather(torch.einsum("bkgts,bskh->btkgh", p, cv), -1)


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


def init_cross_cache(params, memory: Tensor, cfg: ModelConfig, tp=None
                     ) -> Dict[str, Tensor]:
    """Cross-attention keys and values of the encoder's output ``memory``
    (B, F, D), computed once: {"k", "v"} of (B, F, KV, hd); over a mesh
    (``tp``), this rank's shard of them."""
    if tp is not None:
        hs = _cross_heads(params, memory[:, :1], memory, cfg, tp)
        return {"k": hs.kc, "v": hs.vc}
    return {"k": torch.einsum("bsd,dhk->bshk", memory, params["wk"]),
            "v": torch.einsum("bsd,dhk->bshk", memory, params["wv"])}


def cross_attn_decode(params, x: Tensor, cache: Dict[str, Tensor], *,
                      cfg: ModelConfig, tp=None) -> Tensor:
    """One-token cross-attention of x (B, 1, D) over the cached encoder
    keys and values (:func:`init_cross_cache`); no mask, no softcap. Over
    a mesh (``tp``), this rank's heads over its shard of the cache, the
    frames' softmax triples combined over the data axes where the cache
    cuts them."""
    b = x.shape[0]
    if tp is None:
        kvh, g = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads
        q = torch.einsum("btd,dhk->bthk", x, params["wq"]).reshape(
            b, 1, kvh, g, -1)
        out = _sdpa(q, cache["k"], cache["v"], None, 0.0).reshape(
            b, 1, cfg.n_heads, -1)
        return torch.einsum("bthk,hkd->btd", out, params["wo"])
    cut = tp.cache_dim("k", "model")
    if cut not in (None, 2):
        raise NotImplementedError(
            f"cross-attention: the cross cache's k cut over 'model' on dim "
            f"{cut} is not computed")
    q, local = _q_proj(params, x, tp)
    q, h0, kv0, kvn = _q_block(q, local, cfg, tp, cut)
    at = kv0 - (tp.model.rank * (cfg.n_kv_heads // tp.model.size)
                if cut == 2 else 0)
    ck, cv = cache["k"], cache["v"]
    if kvn != ck.shape[2]:
        ck, cv = ck[:, :, at:at + kvn], cv[:, :, at:at + kvn]
    hq = q.shape[2]
    out = _cross_attend(q.reshape(b, 1, kvn, hq // kvn, -1), ck, cv, tp)
    return _project(params, out.reshape(b, 1, hq, -1), h0, cfg, tp)
