"""Optimizers over parameter trees, optax-style ``(init, update)`` pairs:
SGD (+momentum), AdamW with fp32 moments, global-norm clipping and a
cosine schedule (the port's copy of ``repro/optim/optimizers.py``, in the
reference's arithmetic order: bias corrections, ``eps`` outside the
square root, weight decay inside the step).

``update`` writes the new parameters and moments into the given tensors
and returns them, where the reference returns new arrays: its jitted
train step donates them, and at full width (recurrentgemma-2b in fp32:
11.6 GB of weights, 23.2 GB of moments) old and new copies would not fit
on one card together. The step counter and learning rate are 0-d
tensors on the parameters' device (no host sync a step).

The trees' leaves may be DTensors (a train step over a device mesh):
each op keeps the placements, so a gradient given whole (replicated) is
cut to the moments' slice locally, and ``clip_by_global_norm``'s sum
over it is the whole tensor's, the same bits as on plain tensors."""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.tree import tree_leaves, tree_map

Tensor = torch.Tensor
Params = Any
LR = Union[float, Callable[[Tensor], Tensor]]


class OptState(NamedTuple):
    step: Tensor          # int32, 0-d
    mu: Params            # momentum / first moment (None: plain SGD)
    nu: Optional[Params]  # second moment (adamw only)


def _zeros_like_f32(tree: Params) -> Params:
    """fp32 zeros of each leaf's shape, stored as the leaf is: a
    ``DTensor`` gives a ``DTensor`` of the same placements (ZeRO-1
    moments made from parameters placed by ``opt_state_specs``), a meta
    tensor a meta tensor."""
    return tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                    tree)


def _step0(params: Params) -> Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def clip_by_global_norm(grads: Params, max_norm: float
                        ) -> Tuple[Params, Tensor]:
    """(grads scaled by min(1, max_norm / ‖grads‖), ‖grads‖) with the norm
    over every leaf in fp32; new tensors."""
    sq = sum(torch.sum(g.to(torch.float32) ** 2) for g in tree_leaves(grads))
    gnorm = torch.sqrt(torch.clamp(sq, min=1e-20))
    scale = torch.clamp(max_norm / gnorm, max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), gnorm


def sgd(lr: LR, momentum: float = 0.0):
    def init(params: Params) -> OptState:
        mu = _zeros_like_f32(params) if momentum else None
        return OptState(_step0(params), mu, None)

    @torch.no_grad()
    def update(grads: Params, state: OptState, params: Params
               ) -> Tuple[Params, OptState]:
        lr_t = lr(state.step) if callable(lr) else lr
        if momentum:
            def upd(p, m, g):
                m.copy_(momentum * m + g.to(torch.float32))
                p.add_((-lr_t * m).to(p.dtype))
            tree_map(upd, params, state.mu, grads)
        else:
            tree_map(lambda p, g: p.add_((-lr_t * g).to(p.dtype)),
                     params, grads)
        return params, OptState(state.step + 1, state.mu, None)

    return init, update


def adamw(lr: LR, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0):
    def init(params: Params) -> OptState:
        return OptState(_step0(params), _zeros_like_f32(params),
                        _zeros_like_f32(params))

    @torch.no_grad()
    def update(grads: Params, state: OptState, params: Params
               ) -> Tuple[Params, OptState]:
        step = state.step + 1
        lr_t = lr(step) if callable(lr) else lr
        bc1 = 1 - b1 ** step.to(torch.float32)
        bc2 = 1 - b2 ** step.to(torch.float32)

        def upd(p, m, v, g):
            # one leaf at a time, so its temporaries die with the call
            g = g.to(torch.float32)
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * torch.square(g))
            step_val = (m / bc1) / (torch.sqrt(v / bc2) + eps) \
                + weight_decay * p.to(torch.float32)
            p.copy_((p.to(torch.float32) - lr_t * step_val).to(p.dtype))

        tree_map(upd, params, state.mu, state.nu, grads)
        return params, OptState(step, state.mu, state.nu)

    return init, update


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable[[Tensor], Tensor]:
    def sched(step: Tensor) -> Tensor:
        step = step.to(torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = base_lr * (min_frac + (1 - min_frac) * 0.5 *
                         (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return sched


OPTIMIZERS = {"sgd": sgd, "adamw": adamw}
