"""Serving steps: one-token decode (``serve_step``), the prefill step and
greedy generation (the port's copy of ``repro/serve/decode.py``).

Without a mesh the steps run on the params' device. Over a live
``DeviceMesh`` they store weights by ``param_specs``, the cache by
``cache_specs`` and tokens and logits by ``batch_specs``, as the
reference's ``in_shardings`` / ``out_shardings`` do, and compute each
rank's share (``models/parallel.py``): heads, d_ff, experts and
vocabulary over ``model`` (tensor-parallel), the batch over the data
axes when it divides them, else the cache's sequence (batch-1
distributed-cache decode, the reference's ``long_500k``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.common import softcap
from repro_torch.models.model import Model, as_dtype
from repro_torch.tree import tree_map

Tensor = torch.Tensor


def make_serve_step(model: Model, mesh=None, *, batch: Optional[int] = None,
                    max_len: Optional[int] = None,
                    cache_dtype=torch.bfloat16
                    ) -> Tuple[Callable, Optional[Dict[str, Any]]]:
    """``(serve_step, shardings)`` with ``serve_step(params, cache, token,
    index) -> (next_token_logits, new_cache)``. PyTorch runs eagerly, so
    nothing is compiled.

    ``mesh=None``: a cache from ``model.init_cache`` or ``model.prefill``
    on one device, updated in place; ``shardings`` is ``None`` and the
    other arguments have nothing to size. Over a mesh, ``batch`` and
    ``max_len`` size the cache and ``shardings`` holds the ``Spec`` trees
    ``"params"``, ``"cache"`` (of a ``cache_dtype`` cache; the specs do not
    depend on it) and ``"token"``, their DTensor ``"placements"`` and the
    ``"mesh"``; the step takes params, cache and tokens stored by them
    (params as ``Model.init(..., mesh=)`` draws them; whole tokens are
    cut here) and returns
    the logits stored by the token's spec and the cache, written in
    place. Raises ``NotImplementedError`` for the families the mesh steps
    do not compute yet (recurrent layers, the encoder-decoder)."""
    cfg = model.cfg
    if mesh is None:
        def serve_step(params, cache, token, index):
            return tfm.decode_step(params, cfg, cache, token, index)
        return serve_step, None
    from repro_torch.models.parallel import check_family, mesh_model
    check_family(cfg)
    if batch is None or max_len is None:
        raise ValueError("a serve step over a mesh needs batch and max_len")
    mm = mesh_model(model, mesh)
    cspecs = mm.cache_specs(batch, max_len, as_dtype(cache_dtype))
    shardings = _shardings(mesh, params=mm.pspecs, cache=cspecs,
                           token=mm.batch_spec(batch))

    def serve_step(params, cache, token, index):
        if token.shape[0] != batch:
            raise ValueError(f"a batch of {token.shape[0]} tokens for a "
                             f"step made for {batch}")
        return mm.decode(params, cache, token, index, cspecs)
    return serve_step, shardings


def _shardings(mesh, **specs) -> Dict[str, Any]:
    from repro_torch.sharding import placements
    out: Dict[str, Any] = dict(specs, mesh=mesh)
    out["placements"] = {k: tree_map(lambda s: placements(s, mesh), v)
                         for k, v in specs.items()}
    return out


def make_prefill_step(model: Model, mesh=None, *,
                      batch: Optional[int] = None) -> Callable:
    """``prefill(params, batch_inputs)``: the full-sequence forward
    (``forward_hidden``: a VLM's ``patches`` as a bidirectional prefix,
    an encoder-decoder's ``frames`` encoded) producing last-position
    logits. The one serve path where the image prefix runs. Over a mesh,
    params stored by ``param_specs`` (``Model.init(..., mesh=)``), the
    inputs' rows cut by ``batch_specs`` (``batch``, when given, is the
    batch it must have) and the logits stored by it."""
    cfg = model.cfg
    if mesh is None:
        def prefill(params, batch_inputs):
            h, _, _ = tfm.forward_hidden(params, cfg, batch_inputs)
            logits = tfm.logits_fn(params, cfg, h[:, -1:])[:, 0]
            return softcap(logits, cfg.logit_softcap)
        return prefill
    from repro_torch.models.parallel import mesh_model
    mm = mesh_model(model, mesh)

    def prefill(params, batch_inputs):
        b = batch_inputs["tokens"].shape[0]
        if batch is not None and b != batch:
            raise ValueError(f"a batch of {b} for a prefill step made for "
                             f"{batch}")
        return mm.last_logits(params, batch_inputs)
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
