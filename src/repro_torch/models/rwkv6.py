"""RWKV-6 "Finch" time-mix (arXiv:2404.05892) with data-dependent decay
(the port's copy of ``repro/models/rwkv6.py``).

Per head (head_dim n): a state S in R^{n x n} accumulating decayed
k (x) v outer products:

  S_t = diag(w_t) S_{t-1} + k_t v_t^T
  o_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t

with per-channel data-dependent decay
  w_t = exp(-exp(clip(w0 + tanh(x_t W_w1) W_w2, -8, 4)))  in (0, 1)

and token-shift mixing for the r/k/v/w projections. The full sequence
runs the reference's two-level scan: a per-token recurrence inside
chunks of ``_SCAN_CHUNK`` positions, each chunk rematerialized in the
backward, so training keeps O(T / chunk) states. A step is two launches:
S^T r and S <- w S + k v^T (the chunk's outer products are formed at
once, and the bonus term (u·k·r) v of every position outside the loop).
The recurrence is eager PyTorch, as the reference's is XLA: no Pallas
kernel lies on this path. The state lives in the activations' dtype.

Over a mesh (``tp``), each rank runs the recurrence on one block of the
heads, with no collective inside the per-token loop: the block its
weights hold where the rules cut them over ``model`` (``w_r`` / ``w_k``
on their columns, ``w_v`` / ``w_o`` / ``w_decay1`` on their rows,
``w_decay2`` on its columns, ``mu`` on D; whole leaves are cut here),
else, at batch 1 over the data axes, the heads its state ``S`` holds.
A row-parallel projection's partial products are summed and then cut
to the block; ``mu`` is gathered whole (4 x D weights) so that the
column-parallel products see the whole mix; ``w_o``'s partial products
are summed over the axis.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import dense_init, remat
from repro_torch.models.mlp import _token_shift

Tensor = torch.Tensor
_DECAY_LORA = 64
_SCAN_CHUNK = 64


def init_rwkv6(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32
               ) -> Dict[str, Tensor]:
    d = cfg.d_model
    dev = gen.device
    return {
        "w_r": dense_init(gen, (d, d), dtype=dtype),
        "w_k": dense_init(gen, (d, d), dtype=dtype),
        "w_v": dense_init(gen, (d, d), dtype=dtype),
        "w_o": dense_init(gen, (d, d), dtype=dtype),
        "w_decay1": dense_init(gen, (d, _DECAY_LORA), scale=0.02,
                               dtype=dtype),
        "w_decay2": dense_init(gen, (_DECAY_LORA, d), scale=0.02,
                               dtype=dtype),
        # exp(-exp(-5)): slow decay
        "w0": torch.full((d,), -5.0, dtype=dtype, device=dev),
        "u": dense_init(gen, (d,), scale=1.0, dtype=dtype),      # bonus
        # token-shift mixes (r, k, v, w)
        "mu": torch.full((4, d), 0.5, dtype=dtype, device=dev),
    }


# the dims the mesh steps compute each leaf cut on
_CUTS = {"w_r": (1, 0), "w_k": (1, 0), "w_v": (0, 1), "w_o": (0,),
         "w_decay1": (0,), "w_decay2": (1,), "mu": (1,)}


def _split(tp, n_heads: int):
    """(``models.parallel``, the axis whose ranks compute a block of the
    heads, the heads a block)."""
    from repro_torch.models import parallel as par
    ax = par.split_axis(tp, _CUTS, "S", 1)
    if n_heads % ax.size:
        raise NotImplementedError(
            f"RWKV6: {n_heads} heads do not split over {ax.size} ranks")
    return par, ax, n_heads // ax.size


def _col(par, tp, ax, params, name: str, x: Tensor) -> Tensor:
    """The block of ``x @ params[name]``'s columns (heads) ``ax`` gives
    this rank: column-parallel where the leaf is cut on its columns;
    where it is cut on its rows, the partial products summed over
    ``model`` and cut to the block; a whole leaf cut here."""
    if tp is not None and tp.dim(name) == 0:
        w = params[name]
        n = w.shape[0]
        y = tp.psum(x[..., tp.model.rank * n:(tp.model.rank + 1) * n] @ w)
        return par.block(y, ax, -1)
    return x @ par.take(tp, params, name, 1, ax)


def _projections(params, x: Tensor, shifted: Tensor, tp, ax):
    from repro_torch.models import parallel as par
    mu = params["mu"]
    dm = None if tp is None else tp.dim("mu")
    if dm is not None:
        mu = tp.gather(mu, dm)

    def mix(i):
        return x * mu[i] + shifted * (1.0 - mu[i])
    r, k, v = (_col(par, tp, ax, params, n, mix(i))
               for i, n in enumerate(("w_r", "w_k", "w_v")))
    d1 = None if tp is None else tp.dim("w_decay1")
    if d1 is None:
        dec = mix(3) @ params["w_decay1"]
    else:                       # row-parallel: this rank's rows of D
        n = params["w_decay1"].shape[0]
        dec = tp.psum(mix(3)[..., tp.model.rank * n:(tp.model.rank + 1) * n]
                      @ params["w_decay1"])
    dec = torch.tanh(dec) @ par.take(tp, params, "w_decay2", 1, ax)
    log_w = -torch.exp(torch.clamp(
        par.block(params["w0"], ax, 0).to(torch.float32)
        + dec.to(torch.float32), -8.0, 4.0))
    w = torch.exp(log_w).to(x.dtype)                      # in (0, 1)
    return r, k, v, w


def _heads(a: Tensor, n_heads: int) -> Tensor:
    """(B, T, D) -> (T, B, H, n), contiguous, so a position is one slab."""
    b, t, d = a.shape
    return a.reshape(b, t, n_heads, d // n_heads).transpose(0, 1).contiguous()


def _bonus(params, r: Tensor, k: Tensor, v: Tensor, ax) -> Tensor:
    """(diag(u) k v^T)^T r = (Σ_i u_i k_i r_i) v over (…, H, n), the
    heads of ``ax``'s block."""
    from repro_torch.models import parallel as par
    h, n = r.shape[-2:]
    u = par.block(params["u"], ax, 0).reshape(h, n)
    return torch.sum(u * k * r, dim=-1, keepdim=True) * v


def _chunk(S: Tensor, r: Tensor, k: Tensor, v: Tensor, w: Tensor
           ) -> Tuple[Tensor, Tensor]:
    """The recurrence over one chunk, r/k/v/w (c, B, H, n), from S
    (B, H, n, n): returns the state after it and each position's
    S_{t-1}^T r_t (c, B, H, n). The heads are one batch of B·H and each
    position's operands are views made before the loop, so a step costs
    two dispatches (the loop is bound by them on the card)."""
    c, b, h, n = r.shape
    kv = (k[..., :, None] * v[..., None, :]).reshape(c, b * h, n, n)
    kv, rs = kv.unbind(0), r.reshape(c, b * h, 1, n).unbind(0)
    ws = w.reshape(c, b * h, n, 1).unbind(0)
    S = S.reshape(b * h, n, n)
    outs = []
    for i in range(c):
        outs.append(torch.bmm(rs[i], S))
        S = torch.addcmul(kv[i], ws[i], S)
    return S.reshape(b, h, n, n), torch.stack(outs).reshape(c, b, h, n)


def rwkv6_prefill(params, x: Tensor, cfg: ModelConfig, tp=None
                  ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Full-sequence forward of x (B, T, D) that also returns the decode
    state T decode steps leave: ``S`` after position T-1 (the last chunk
    is ragged, not zero-padded as in the reference, whose padded steps
    would zero S) and ``prev`` = x[:, -1]. Over a mesh (``tp``), this
    rank's block of the heads (see the module's docstring) and its shard
    of the state."""
    b, t, d = x.shape
    n = d // cfg.n_heads
    par, ax, hn = _split(tp, cfg.n_heads)
    r, k, v, w = (_heads(a, hn) for a in
                  _projections(params, x, _token_shift(x), tp, ax))
    S = x.new_zeros(b, hn, n, n)
    outs = []
    for s in range(0, t, _SCAN_CHUNK):
        sl = slice(s, s + _SCAN_CHUNK)
        S, o = remat(_chunk, S, r[sl], k[sl], v[sl], w[sl])
        outs.append(o)
    out = torch.cat(outs) + _bonus(params, r, k, v, ax)   # (T, B, H, n)
    y = par.sum_over(out.transpose(0, 1).reshape(b, t, hn * n)
                     @ par.take(tp, params, "w_o", 0, ax), ax)
    return y, {"S": par.to_cache(tp, S, "S", 1, ax),
               "prev": par.to_cache(tp, x[:, -1], "prev", 1)}


def rwkv6_forward(params, x: Tensor, cfg: ModelConfig, tp=None) -> Tensor:
    """x: (B, T, D) full-sequence (train / prefill)."""
    return rwkv6_prefill(params, x, cfg, tp)[0]


def init_rwkv6_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> Dict[str, Tensor]:
    h = cfg.n_heads
    n = cfg.d_model // h
    return {"S": torch.zeros((batch, h, n, n), dtype=dtype, device=device),
            "prev": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                device=device)}


def rwkv6_decode(params, x: Tensor, state: Dict[str, Tensor],
                 cfg: ModelConfig, tp=None
                 ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One-token decode. x: (B, 1, D). Over a mesh (``tp``), this rank's
    block of the heads, the state read from and written to its shard
    (``prev`` gathered whole for the token shift)."""
    b, _, d = x.shape
    n = d // cfg.n_heads
    par, ax, hn = _split(tp, cfg.n_heads)
    prev = par.from_cache(tp, state["prev"], "prev", 1)
    r, k, v, w = (a.reshape(b, 1, hn, n) for a in
                  _projections(params, x, prev[:, None, :], tp, ax))
    S, o = _chunk(par.from_cache(tp, state["S"], "S", 1, ax),
                  r.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1),
                  w.transpose(0, 1))
    out = o[0] + _bonus(params, r[:, 0], k[:, 0], v[:, 0], ax)
    y = par.sum_over(out.reshape(b, 1, hn * n)
                     @ par.take(tp, params, "w_o", 0, ax), ax)
    return y, {"S": par.to_cache(tp, S, "S", 1, ax),
               "prev": par.to_cache(tp, x[:, 0], "prev", 1)}
