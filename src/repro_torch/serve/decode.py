"""Serving steps: one-token decode (``serve_step``), the prefill step and
greedy generation (the port's copy of ``repro/serve/decode.py`` for one
device; the sharded variants wait for ``torch.distributed``)."""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.common import softcap
from repro_torch.models.model import Model

Tensor = torch.Tensor


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("sharded serving over a mesh is not "
                                  "ported yet; pass mesh=None")


def make_serve_step(model: Model, mesh=None) -> Tuple[Callable, None]:
    """``(serve_step, None)`` with ``serve_step(params, cache, token,
    index) -> (next_token_logits, new_cache)`` over a cache from
    ``model.init_cache`` or ``model.prefill``. PyTorch runs eagerly, so
    nothing is compiled, and the reference's sharding arguments (batch,
    max_len, cache dtype) have nothing to size."""
    _no_mesh(mesh)
    cfg = model.cfg

    def serve_step(params, cache, token, index):
        return tfm.decode_step(params, cfg, cache, token, index)
    return serve_step, None


def make_prefill_step(model: Model, mesh=None) -> Callable:
    """Full-sequence forward producing last-position logits."""
    _no_mesh(mesh)
    cfg = model.cfg

    def prefill(params, batch_inputs):
        h, _, _ = tfm.forward_hidden(params, cfg, batch_inputs)
        logits = tfm.logits_fn(params, cfg, h[:, -1:])[:, 0]
        return softcap(logits, cfg.logit_softcap)
    return prefill


def greedy_generate(model: Model, params, prompt: Tensor, steps: int,
                    max_len: int) -> Tensor:
    """The reference's generation helper: prefill the prompt, then feed
    the prompt's last token again at position T and ``steps`` greedy
    tokens after it. Returns (B, T + steps)."""
    s = prompt.shape[1]
    _, cache = model.prefill(params, {"tokens": prompt}, max_len)
    tok = prompt[:, -1]
    out = [prompt]
    for i in range(steps):
        logits, cache = tfm.decode_step(params, model.cfg, cache, tok, s + i)
        tok = torch.argmax(logits, dim=-1)
        out.append(tok[:, None])
    return torch.cat(out, dim=1)
