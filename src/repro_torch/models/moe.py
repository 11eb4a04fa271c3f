"""Mixture-of-Experts FFN with top-k routing and capacity-bounded
dispatch (the port's copy of ``repro/models/moe.py``).

Routing is the reference's: each token's top-k experts by router
probability, their weights renormalized to sum to 1, and each expert
keeping at most C = ``moe_capacity`` tokens of its group, the C largest
weights. Both selections break exact ties as ``lax.top_k`` does, the
lower index first (a stable descending sort; ``torch.topk`` promises no
order among equal values). Under top-1 every routed weight is exactly
1.0, so which tokens an overfull expert drops is decided by that order
alone.

Dispatch computes only the kept (token, expert) pairs: the reference
fills each expert's C slots with zero-weight tokens when fewer are
routed to it, and those slots add exactly 0. So a decode step at batch 1
reads the weights of its k experts, not of all E. The reference's
sharding hints (``constrain``, the model axis) have no counterpart on
one device.

Under :func:`route_over_ranks` a full-sequence forward routes the tokens
of every rank of a ``torch.distributed`` group as one group, each rank
computing only its own rows: the reference's forward of a batch sharded
over its data axes, whose semantics are those of the unsharded program.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import act_fn, dense_init, gelu

Tensor = torch.Tensor


def _expert_init(gen: torch.Generator, shape: Sequence[int], dtype
                 ) -> Tensor:
    """An (E, ·, ·) stack with the reference's ``dense_init`` std,
    1/sqrt(shape[0]) = 1/sqrt(E) (its fan-in is the leading axis), drawn
    one expert at a time in fp32 into a tensor of ``dtype``: llama4's
    (128, 5120, 8192) stack would take 20 GiB in fp32 drawn whole."""
    std = 1.0 / math.sqrt(shape[0])
    out = torch.empty(tuple(shape), dtype=dtype, device=gen.device)
    for e in range(shape[0]):
        out[e] = dense_init(gen, shape[1:], scale=std)
    return out


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32
             ) -> Dict[str, Tensor]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": dense_init(gen, (d, e), scale=0.02, dtype=dtype),
         "w_up": _expert_init(gen, (e, d, f), dtype),
         "w_down": _expert_init(gen, (e, f, d), dtype)}
    if cfg.ffn_act in ("swiglu", "geglu"):
        p["w_gate"] = _expert_init(gen, (e, d, f), dtype)
    return p


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    cap = int(cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts)
    return min(n_tokens, max(8, cap))


def _top(x: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """The ``k`` largest along the last axis, exact ties in index order
    (``lax.top_k``'s)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class Routing(NamedTuple):
    """The kept (expert, token) pairs of a forward, in expert order, then
    group, then weight (ties: token index). ``token`` indexes the
    forward's tokens as grouped (group-major); ``gate`` is the pair's
    weight (fp32, > 0); ``counts[e]`` the pairs of expert e."""
    expert: Tensor
    token: Tensor
    gate: Tensor
    counts: Tuple[int, ...]


def route(combine: Tensor, cap: int) -> Routing:
    """Capacity selection over the combined weights ``combine`` (G, n, E)
    of G groups of n tokens: each expert keeps, within each group, the
    ``cap`` tokens of largest weight (the reference's
    ``lax.top_k(combine.T, cap)``) that have a weight at all."""
    g, n, e = combine.shape
    w, idx = _top(combine.transpose(1, 2), cap)           # (G, E, C)
    keep = (w > 0).transpose(0, 1)                        # (E, G, C)
    ex, gi, slot = keep.nonzero(as_tuple=True)
    token = gi * n + idx.transpose(0, 1)[ex, gi, slot]
    gate = combine.reshape(g * n, e)[token, ex]
    counts = tuple(torch.bincount(ex, minlength=e).tolist())
    return Routing(ex, token, gate, counts)


class _Ranks(NamedTuple):
    group: Optional[dist.ProcessGroup]
    world: int
    rank: int


_OVER_RANKS: List[_Ranks] = []     # the innermost route_over_ranks last


@contextmanager
def route_over_ranks(group: Optional[dist.ProcessGroup] = None
                     ) -> Iterator[None]:
    """While open, every full-sequence :func:`moe_forward` (``group=None``)
    routes the tokens of all ranks of ``group`` (``None``: the default
    group) as one group. Each rank holds an equal, contiguous block of the
    global batch's rows, in rank order, and computes only those rows;
    every rank must run the same MoE forwards in the same order (the
    backward's rematerialized ones too, so keep it open over the
    backward). With one rank it changes nothing and issues no
    collective."""
    world = dist.get_world_size(group)
    if world > 1:
        _OVER_RANKS.append(_Ranks(group, world, dist.get_rank(group)))
    try:
        yield
    finally:
        if world > 1:
            _OVER_RANKS.pop()


def _route_global(combine: Tensor, probs: Tensor, cfg: ModelConfig,
                  ranks: _Ranks) -> Tuple[Routing, Tensor]:
    """(this rank's kept pairs, its share of the aux loss) of the global
    routing, from its own (n, E) ``combine`` and ``probs``: the keep set
    of :func:`route` over every rank's ``combine`` gathered (global token
    = rank·n + local token; the capacity of world·n tokens), restricted to
    this rank's tokens; the gates from the local ``combine`` (they carry
    the router's gradient). The aux share is E·w·Σ_e f_e·Σ_local p_e / N
    with f_e the fraction of all N tokens routed to e (no gradient, as
    the reference's ``combine > 0``): summed over the ranks, the
    reference's aux loss and its gradient."""
    n, e = combine.shape
    with torch.no_grad():
        parts = [torch.empty_like(combine) for _ in range(ranks.world)]
        dist.all_gather(parts, combine.detach().contiguous(),
                        group=ranks.group)
        every = torch.cat(parts)
        n_all = every.shape[0]
        rt = route(every[None], moe_capacity(cfg, n_all))
        frac_tokens = torch.mean((every > 0).to(torch.float32), dim=0)
    lo = ranks.rank * n
    mine = (rt.token >= lo) & (rt.token < lo + n)
    ex, token = rt.expert[mine], rt.token[mine] - lo
    counts = tuple(torch.bincount(ex, minlength=e).tolist())
    aux = e * torch.sum(frac_tokens * probs.sum(0) / n_all) \
        * cfg.router_aux_weight
    return Routing(ex, token, combine[token, ex], counts), aux


def _expert_ffn(params, e: int, x: Tensor, cfg: ModelConfig) -> Tensor:
    if "w_gate" in params:
        act = act_fn("silu" if cfg.ffn_act == "swiglu" else "gelu")
        h = act(x @ params["w_gate"][e]) * (x @ params["w_up"][e])
    else:
        h = gelu(x @ params["w_up"][e])
    return h @ params["w_down"][e]


def moe_forward(params, x: Tensor, cfg: ModelConfig,
                group: Optional[int] = None) -> Tuple[Tensor, Tensor]:
    """x: (B, T, D) -> (out, aux_loss). ``group=None`` routes all B·T
    tokens as one group (the reference's full-sequence forward);
    ``group=B`` routes each position's B tokens as a group of its own,
    as the reference's prefill does (T decode steps of B tokens). The
    aux loss is the reference's Switch-style E·Σ_e f_e·p_e times
    ``router_aux_weight`` in fp32, averaged over the groups. Under
    :func:`route_over_ranks`, ``group=None`` routes every rank's tokens
    as one group and the aux is this rank's share of theirs."""
    b, t, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    ranks = _OVER_RANKS[-1] if group is None and _OVER_RANKS else None
    if group is None:
        xg = x.reshape(1, b * t, d)
    elif group == b:
        xg = x.transpose(0, 1)                            # (T, B, D)
    else:
        raise ValueError(f"group={group}: route all tokens (None) or each "
                         f"position's {b} tokens ({b})")
    g, n, _ = xg.shape

    logits = (xg @ params["router"]).to(torch.float32)    # (G, n, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = _top(probs, k)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    # per-token-per-expert combined weight; 0 where not routed
    combine = torch.zeros_like(probs).scatter(-1, top_e, top_p)

    if ranks is None:
        frac_tokens = torch.mean((combine > 0).to(torch.float32), dim=1)
        frac_prob = torch.mean(probs, dim=1)
        aux = torch.mean(e * torch.sum(frac_tokens * frac_prob, dim=-1)
                         * cfg.router_aux_weight)
        rt = route(combine, moe_capacity(cfg, n))
    else:
        rt, aux = _route_global(combine[0], probs[0], cfg, ranks)
    xt = xg.reshape(g * n, d)
    out = torch.zeros_like(xt)
    start = 0
    for ex, c in enumerate(rt.counts):
        if not c:
            continue
        tok = rt.token[start:start + c]
        y = _expert_ffn(params, ex, xt[tok], cfg)
        y = y * rt.gate[start:start + c, None].to(y.dtype)
        out.index_add_(0, tok, y)
        start += c
    out = out.reshape(g, n, d)
    if group is not None:
        out = out.transpose(0, 1)
    return out.reshape(b, t, d), aux
