"""Public model API: ``Model(cfg)`` bundles init / loss / grad / encode /
prefill / decode for any registered architecture (the port's copy of
``repro/models/model.py``). Parameters, gradients and caches are plain
dicts of tensors; ``Model`` only carries the static config."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig, get_arch, reduced
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.common import softcap
from repro_torch.models.frontends import make_batch
from repro_torch.tree import tree_leaves, tree_unflatten

Tensor = torch.Tensor
Params = Dict[str, Any]
DTypeLike = Union[str, torch.dtype]


def as_dtype(dtype: DTypeLike) -> torch.dtype:
    """``torch.float32`` from ``torch.float32`` or ``"float32"``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    dt = getattr(torch, str(dtype), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return dt


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    # -- init ---------------------------------------------------------------
    def init(self, seed: int = 0, *, device: DeviceLike = "cuda",
             dtype: DTypeLike = torch.float32, mesh=None) -> Params:
        """Random weights from a ``torch.Generator`` on ``device`` seeded
        with ``seed``; raises on ``"cuda"`` without a GPU. With ``mesh``
        (a live ``DeviceMesh``), stored by ``param_specs`` as DTensors,
        each layer cut to this rank's slice as soon as it is drawn, so no
        rank holds more than one whole layer (and one leaf in fp32): the
        same bits as ``shard_tree(init(seed), specs, mesh)``."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        place = None
        if mesh is not None:
            from repro_torch.sharding import param_specs, shard_tree
            specs = param_specs(self.param_shapes(dtype), self.cfg, mesh)

            def place(path, sub):
                spec = specs
                for k in path:
                    spec = spec[k]
                return shard_tree(sub, spec, mesh)
        return tfm.init_params(gen, self.cfg, as_dtype(dtype), place)

    def param_shapes(self, dtype: DTypeLike = torch.float32) -> Params:
        """``init``'s tree on the meta device (shapes and dtypes, no
        storage): the reference's ``jax.eval_shape(model.init, key)``."""
        return tfm.param_shapes(self.cfg, as_dtype(dtype))

    # -- training -----------------------------------------------------------
    def loss(self, params: Params, batch: Dict[str, Tensor],
             loss_chunk: int = 512) -> Tuple[Tensor, Dict[str, Tensor]]:
        return tfm.loss_fn(params, self.cfg, batch, loss_chunk)

    def grad_fn(self, loss_chunk: int = 512) -> Callable:
        """``fn(params, batch) -> ((loss, metrics), grads)`` with grads in
        the params' tree: ``jax.value_and_grad(loss, has_aux=True)``, by
        ``torch.autograd.grad`` over the leaves. Leaves ``params`` as they
        are (their aliases are the ones marked to require grad)."""
        def value_and_grad(params: Params, batch: Dict[str, Tensor]):
            xs = [p.detach().requires_grad_() for p in tree_leaves(params)]
            with torch.enable_grad():
                loss, metrics = self.loss(tree_unflatten(params, xs), batch,
                                          loss_chunk)
                grads = torch.autograd.grad(loss, xs)
            metrics = {k: v.detach() for k, v in metrics.items()}
            return (loss.detach(), metrics), tree_unflatten(params, grads)
        return value_and_grad

    # -- serving ------------------------------------------------------------
    def init_cache(self, params: Params, batch: int, max_len: int,
                   memory: Optional[Tensor] = None) -> Params:
        """An empty decode cache in the weights' dtype; an
        encoder-decoder's holds ``memory``'s cross-attention keys and
        values (zeros without it). For params stored on a mesh, DTensors
        stored by ``cache_specs`` (each rank allocates its shards)."""
        mesh = _mesh_of(params)
        if mesh is not None:
            return _mesh_model(self, mesh).init_cache(params, batch, max_len,
                                                      memory)
        return tfm.init_cache(params, self.cfg, batch, max_len,
                              memory=memory)

    def encode(self, params: Params, frames: Tensor) -> Tensor:
        """The encoder's output (B, F, D) for frames (B, F, D)."""
        return tfm.encode(params, self.cfg, frames)

    def prefill(self, params: Params, batch: Dict[str, Tensor],
                max_len: int) -> Tuple[Tensor, Params]:
        """Run the prompt through one full-sequence forward and fill a
        cache. Returns (last logits (B, V), cache), the same as the
        reference's ``Model.prefill`` (T decode steps); the cache is in
        the weights' dtype (the reference's ``cache_dtype`` option is not
        kept: decode computes in one dtype). An encoder-decoder encodes
        ``batch["frames"]`` first. ``batch["patches"]`` is ignored, as the
        reference's ``Model.prefill`` ignores it: the image prefix runs
        only through ``forward_hidden`` (``serve.make_prefill_step``, the
        loss). For params stored on a mesh, the logits are stored by
        ``batch_specs`` and the cache by ``cache_specs``, each rank
        computing its shard (``models/parallel.py``; an encoder-decoder's
        ``frames`` rows cut by ``batch_specs`` too, encoded over the
        mesh)."""
        tokens = batch["tokens"]
        if tokens.shape[1] > max_len:
            raise ValueError(f"prompt of {tokens.shape[1]} tokens does not "
                             f"fit max_len {max_len}")
        mesh = _mesh_of(params)
        if mesh is not None:
            return _mesh_model(self, mesh).prefill(params, batch, max_len)
        memory = (self.encode(params, batch["frames"]) if self.cfg.is_encdec
                  else None)
        h, cache = tfm.prefill_hidden(params, self.cfg, tokens, max_len,
                                      memory=memory)
        logits = tfm.logits_fn(params, self.cfg, h[:, -1:])[:, 0]
        return softcap(logits, self.cfg.logit_softcap), cache

    def decode_step(self, params: Params, cache: Params, token: Tensor,
                    index: int) -> Tuple[Tensor, Params]:
        """One decode step; for params stored on a mesh, over it (the
        logits stored by ``batch_specs``, the cache written in place)."""
        mesh = _mesh_of(params)
        if mesh is not None:
            return _mesh_model(self, mesh).decode(params, cache, token, index)
        return tfm.decode_step(params, self.cfg, cache, token, index)

    # -- helpers ------------------------------------------------------------
    def dummy_batch(self, seed: int, batch: int, seq: int, *,
                    device: DeviceLike = "cpu") -> Dict[str, Tensor]:
        """``frontends.make_batch`` in fp32: the same seed gives the same
        batch on every device."""
        return make_batch(seed, self.cfg, batch, seq, device=device)


def _mesh_of(params: Params):
    from repro_torch.models.parallel import mesh_of
    return mesh_of(params)


def _mesh_model(model: Model, mesh):
    from repro_torch.models.parallel import mesh_model
    return mesh_model(model, mesh)


def build_model(arch: str, smoke: bool = False) -> Model:
    cfg = get_arch(arch)
    if smoke:
        cfg = reduced(cfg)
    return Model(cfg)
