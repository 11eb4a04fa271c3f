"""Tensor-parallel compute over a ``DeviceMesh``: what GSPMD makes of the
reference's serve steps when their weights, caches and tokens are stored
by ``param_specs``, ``cache_specs`` and ``batch_specs``.

Storage stays the specs' (DTensors); a step computes on each rank's local
shards with explicit collectives, in the layout the reference's
``constrain`` sites name:

* along ``model``, a leaf cut on its heads, d_ff, experts or vocab is
  computed column-parallel and the product that contracts over the cut
  dim row-parallel, followed by one all-reduce (``TP.psum``); the router's
  logits, new K/V rows and the final logits are all-gathered
  (``TP.gather``). A rank never computes another rank's heads, d_ff,
  experts or vocabulary rows;
* along the data axes (``pod`` and ``data``, flattened major to minor), a
  batch that divides them is split, each rank computing its own rows (an
  MoE layer still routes every rank's tokens as one group); otherwise a
  cache whose sequence divides them holds a contiguous slot range a rank
  and one-token attention combines the ranks' partial softmax
  (distributed-cache decode, the reference's ``long_500k``);
* a leaf that ``param_specs`` also cuts over the data axes (``fsdp``) is
  all-gathered over them one layer at a time, just before the layer runs,
  and freed after it (``TP.unshard``).

:class:`TP` carries the groups and the spec trees of the module it is
handed to; it is ``None`` off a mesh, and the model code then issues no
collective. :class:`MeshModel` holds a model's specs and groups on one
mesh and the conversions between DTensors and local shards.
"""
from __future__ import annotations

import math
import weakref
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.sharding.placement import (_contiguous_stride, _coord,
                                           _entry_axes, clients_group,
                                           local_slices, placements)
from repro_torch.sharding.specs import (Spec, axis_sizes, batch_specs,
                                        cache_specs, data_axes, param_specs)
from repro_torch.tree import tree_map

Tensor = torch.Tensor

# collectives issued by TP since the last reset, by kind (each call of
# dist.all_reduce / dist.all_gather counts one)
_COUNTS: Dict[str, int] = {"all_reduce": 0, "all_gather": 0}


def reset_collective_counts() -> None:
    for k in _COUNTS:
        _COUNTS[k] = 0


def collective_counts() -> Dict[str, int]:
    return dict(_COUNTS)


class Axis(NamedTuple):
    """A mesh axis (or the data axes flattened) through this rank: its
    group (``None`` at size 1), this rank's index along it, its size."""
    group: Optional[dist.ProcessGroup]
    rank: int
    size: int


class Groups(NamedTuple):
    model: Axis
    data: Axis
    daxes: Tuple[str, ...]


_ONE = Axis(None, 0, 1)


def axis_groups(mesh) -> Groups:
    """The ``model`` axis and the data axes of the live ``mesh`` through
    this rank (the mesh's own groups: ``DeviceMesh`` makes each once)."""
    sizes = axis_sizes(mesh)
    model = _ONE
    if sizes.get("model", 1) > 1:
        model = Axis(mesh.get_group("model"), _coord(mesh)["model"],
                     sizes["model"])
    daxes = data_axes(mesh)
    dsize = math.prod(sizes[a] for a in daxes)
    data = _ONE
    if dsize > 1:
        group = clients_group(mesh)
        data = Axis(group, dist.get_rank(group), dsize)
    return Groups(model, data, daxes)


def _all_reduce(x: Tensor, axis: Axis, op=dist.ReduceOp.SUM) -> Tensor:
    if axis.size > 1:
        dist.all_reduce(x, op=op, group=axis.group)
        _COUNTS["all_reduce"] += 1
    return x


# one collective into one buffer (``all_gather_into_tensor`` is renamed
# ``all_gather_single`` in newer PyTorch)
_GATHER_INTO = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def _all_gather(x: Tensor, axis: Axis, dim: int) -> Tensor:
    if axis.size == 1:
        return x
    x = x.contiguous()
    out = x.new_empty((axis.size * x.shape[0],) + tuple(x.shape[1:]))
    _GATHER_INTO(out, x, group=axis.group)
    _COUNTS["all_gather"] += 1
    dim %= x.dim()
    if dim == 0:
        return out
    out = out.view((axis.size,) + tuple(x.shape)).movedim(0, dim)
    return out.reshape(x.shape[:dim] + (-1,) + x.shape[dim + 1:])


def _dim_of(spec: Optional[Spec], axes: Tuple[str, ...]) -> Optional[int]:
    """The dim whose entry names one of ``axes``, or ``None``."""
    if spec is None:
        return None
    for d, entry in enumerate(spec):
        if set(_entry_axes(entry)) & set(axes):
            return d
    return None


def _child(tree, key):
    if tree is None:
        return None
    if isinstance(tree, (list, tuple)):
        return tree[key]
    return tree.get(key)


class TP:
    """One module's place on the mesh: the groups, its parameters' specs
    and its cache's specs (``None`` where it has none), and whether the
    batch is split over the data axes."""

    __slots__ = ("groups", "pspecs", "cspecs", "batch_split")

    def __init__(self, groups: Groups, pspecs: Any, cspecs: Any = None,
                 batch_split: bool = False):
        self.groups, self.pspecs, self.cspecs = groups, pspecs, cspecs
        self.batch_split = batch_split

    def sub(self, key, cache_key=None) -> "TP":
        """The context of the sub-module (or layer) ``key``, its cache the
        cache's ``cache_key`` (default ``key``)."""
        return TP(self.groups, _child(self.pspecs, key),
                  _child(self.cspecs, key if cache_key is None
                         else cache_key), self.batch_split)

    @property
    def model(self) -> Axis:
        return self.groups.model

    @property
    def data(self) -> Axis:
        return self.groups.data

    # -- where a leaf lies --------------------------------------------------
    def dim(self, name: str) -> Optional[int]:
        """The dim of parameter ``name`` cut over ``model`` (``None``:
        whole on every model rank)."""
        if self.groups.model.size == 1:
            return None
        return _dim_of(_child(self.pspecs, name), ("model",))

    def cache_dim(self, name: str, axis: str) -> Optional[int]:
        """The dim of cache leaf ``name`` cut over ``axis`` (``"model"`` or
        ``"data"`` for the data axes), or ``None``."""
        axes = ("model",) if axis == "model" else self.groups.daxes
        return _dim_of(_child(self.cspecs, name), axes)

    def unshard(self, params: Any) -> Any:
        """``params`` (this module's local shards) with every leaf that its
        spec cuts over the data axes all-gathered over them: whole along
        the data axes, cut along ``model`` only."""
        if self.groups.data.size == 1:
            return params
        return _unshard(params, self.pspecs, self.groups)

    # -- collectives ----------------------------------------------------------
    def psum(self, x: Tensor) -> Tensor:
        """Sum over ``model`` in place (a row-parallel product's partial
        sums)."""
        return _all_reduce(x, self.groups.model)

    def gather(self, x: Tensor, dim: int) -> Tensor:
        """Every ``model`` rank's ``x`` concatenated along ``dim``."""
        return _all_gather(x, self.groups.model, dim)

    def dsum(self, x: Tensor) -> Tensor:
        return _all_reduce(x, self.groups.data)

    def dmax(self, x: Tensor) -> Tensor:
        return _all_reduce(x, self.groups.data, dist.ReduceOp.MAX)

    def dgather(self, x: Tensor, dim: int) -> Tensor:
        return _all_gather(x, self.groups.data, dim)


def _unshard(tree: Any, specs: Any, groups: Groups) -> Any:
    if isinstance(tree, dict):
        return {k: _unshard(v, _child(specs, k), groups)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_unshard(v, _child(specs, i), groups)
                for i, v in enumerate(tree)]
    d = _dim_of(specs, groups.daxes)
    if d is None:
        return tree
    if tuple(a for a in _entry_axes(specs[d]) if a in groups.daxes) \
            != groups.daxes:
        raise NotImplementedError(f"{specs!r} cuts dim {d} over a part of "
                                  f"the data axes {groups.daxes}")
    return _all_gather(tree, groups.data, d)


def _cut_rows(x: Tensor, axis: Axis, what: str) -> Tensor:
    """This rank's contiguous block of ``x``'s leading dim, cut into
    ``axis.size`` equal blocks."""
    n = x.shape[0] // axis.size
    if n * axis.size != x.shape[0]:
        raise ValueError(f"{what}: {x.shape[0]} rows do not split over "
                         f"{axis.size} ranks")
    return x[axis.rank * n:(axis.rank + 1) * n]


# ---------------------------------------------------------------------------
# the families this slice computes over a mesh

def check_family(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what the mesh steps do not
    compute yet: recurrent ("R", "W") layers and the encoder-decoder."""
    kinds = set(cfg.layer_types())
    if "R" in kinds:
        raise NotImplementedError(
            f"{cfg.name}: serving over a mesh does not compute RG-LRU "
            f"('R') layers yet")
    if "W" in kinds:
        raise NotImplementedError(
            f"{cfg.name}: serving over a mesh does not compute RWKV6 "
            f"('W') layers yet")
    if cfg.is_encdec:
        raise NotImplementedError(
            f"{cfg.name}: serving over a mesh does not compute the "
            f"encoder or cross-attention yet")


def _local(x: Any) -> Any:
    return x._local_tensor if isinstance(x, DTensor) else x


def local_tree(tree: Any) -> Any:
    """Each DTensor leaf's local shard (the storage itself: writing to it
    writes the DTensor)."""
    return tree_map(_local, tree)


class MeshModel:
    """A model's parameter specs and groups on one live mesh, and the
    conversions the mesh steps make between DTensors stored by the specs
    and the local shards they compute on."""

    def __init__(self, model, mesh):
        check_family(model.cfg)
        self.model, self.cfg, self.mesh = model, model.cfg, mesh
        self.pspecs = param_specs(model.param_shapes(), model.cfg, mesh)
        self.groups = axis_groups(mesh)

    def batch_spec(self, batch: int) -> Spec:
        return batch_specs(self.cfg, self.mesh, batch)

    def cache_shapes(self, batch: int, max_len: int, dtype) -> Any:
        """The cache's tree on the meta device."""
        from repro_torch.models import transformer as tfm
        return tfm.init_cache({"embed": torch.empty(0, dtype=dtype,
                                                    device="meta"),
                               "layers": []}, self.cfg, batch, max_len)

    def cache_specs(self, batch: int, max_len: int, dtype=torch.float32
                    ) -> Any:
        return cache_specs(self.cache_shapes(batch, max_len, dtype), self.cfg,
                           self.mesh, batch)

    def tp(self, batch: int, cspecs: Any = None) -> TP:
        return TP(self.groups, self.pspecs, cspecs,
                  batch_split=len(self.batch_spec(batch)) > 0)

    def local_params(self, params: Any) -> Any:
        """The local shards of ``params``, DTensors stored by the specs
        (``Model.init(..., mesh=)``)."""
        def leaf(x):
            if not isinstance(x, DTensor):
                raise TypeError("the mesh steps take params stored by "
                                "param_specs (DTensors, as Model.init("
                                "..., mesh=) draws them), not whole "
                                "tensors")
            return x._local_tensor
        return tree_map(leaf, params)

    def local_rows(self, x: Tensor, batch_spec: Spec) -> Tensor:
        """This rank's rows of a (B, ...) input stored by ``batch_spec``:
        a DTensor's local shard, or a whole tensor's block."""
        if isinstance(x, DTensor):
            return x._local_tensor
        if len(batch_spec):
            return _cut_rows(x, self.groups.data, "the batch")
        return x

    def rows_dtensor(self, x: Tensor, batch: int, spec: Spec) -> DTensor:
        """The local rows ``x`` (B/data, ...) as a DTensor of global batch
        ``batch`` stored by ``spec`` on the batch dim."""
        shape = (batch,) + tuple(x.shape[1:])
        full = Spec(*(list(spec) + [None] * (len(shape) - len(spec))))
        return DTensor.from_local(x, self.mesh, placements(full, self.mesh),
                                  run_check=False, shape=shape,
                                  stride=_contiguous_stride(shape))

    def cache_dtensors(self, local: Any, shapes: Any, specs: Any) -> Any:
        """A tree of local cache shards as DTensors of the ``shapes``
        (meta) tree stored by ``specs``."""
        def leaf(x, meta, spec):
            return DTensor.from_local(
                x, self.mesh, placements(spec, self.mesh), run_check=False,
                shape=meta.shape, stride=_contiguous_stride(meta.shape))
        return tree_map(leaf, local, shapes, specs)

    def local_cache_zeros(self, shapes: Any, specs: Any, device) -> Any:
        """This rank's shards of an empty cache: zero keys and values,
        positions (the integer leaves) -1."""
        coord = _coord(self.mesh)

        def leaf(meta, spec):
            sl = local_slices(meta.shape, spec, self.mesh, coord)
            shape = tuple(s.stop - s.start for s in sl)
            fill = 0 if meta.dtype.is_floating_point else -1
            return torch.full(shape, fill, dtype=meta.dtype, device=device)
        return tree_map(leaf, shapes, specs)

    # -- the steps --------------------------------------------------------
    def init_cache(self, params: Any, batch: int, max_len: int) -> Any:
        """An empty cache in the weights' dtype stored by ``cache_specs``:
        each rank allocates only its shards."""
        emb = _local(params["embed"])
        shapes = self.cache_shapes(batch, max_len, emb.dtype)
        specs = cache_specs(shapes, self.cfg, self.mesh, batch)
        return self.cache_dtensors(
            self.local_cache_zeros(shapes, specs, emb.device), shapes, specs)

    def prefill(self, params: Any, batch: Dict[str, Tensor], max_len: int
                ) -> Tuple[DTensor, Any]:
        """``Model.prefill`` over the mesh: (last logits (B, V) stored by
        ``batch_specs``, the cache stored by ``cache_specs``), each rank
        computing its rows, its heads, d_ff and experts and its shard of
        the cache."""
        from repro_torch.models import transformer as tfm
        from repro_torch.models.common import softcap
        tokens = batch["tokens"]
        b = tokens.shape[0]
        lp = self.local_params(params)
        shapes = self.cache_shapes(b, max_len, _local(lp["embed"]).dtype)
        specs = cache_specs(shapes, self.cfg, self.mesh, b)
        tp = self.tp(b, specs)
        bspec = self.batch_spec(b)
        with torch.no_grad():
            lp = tfm.unshard_head(lp, tp)
            h, cache = tfm.prefill_hidden(lp, self.cfg,
                                          self.local_rows(tokens, bspec),
                                          max_len, tp=tp)
            logits = softcap(tfm.logits_fn(lp, self.cfg, h[:, -1:], tp)[:, 0],
                             self.cfg.logit_softcap)
        return (self.rows_dtensor(logits, b, bspec),
                self.cache_dtensors(cache, shapes, specs))

    def last_logits(self, params: Any, batch: Dict[str, Tensor]) -> DTensor:
        """``serve.make_prefill_step``'s function over the mesh: the
        full-sequence forward of ``batch`` (its leaves' rows cut as
        ``batch_specs`` says), last-position logits stored by it."""
        from repro_torch.models import transformer as tfm
        from repro_torch.models.common import softcap
        b = batch["tokens"].shape[0]
        bspec = self.batch_spec(b)
        tp = self.tp(b)
        local = {k: self.local_rows(v, bspec) for k, v in batch.items()}
        with torch.no_grad():
            lp = tfm.unshard_head(self.local_params(params), tp)
            h, _, _ = tfm.forward_hidden(lp, self.cfg, local, tp=tp)
            logits = softcap(tfm.logits_fn(lp, self.cfg, h[:, -1:], tp)[:, 0],
                             self.cfg.logit_softcap)
        return self.rows_dtensor(logits, b, bspec)

    def decode(self, params: Any, cache: Any, token: Tensor, index: int,
               specs: Any = None) -> Tuple[DTensor, Any]:
        """One decode step over the mesh on a cache stored by
        ``cache_specs`` (``specs``, else read off the cache): (logits
        (B, V) stored by ``batch_specs``, ``cache``, written in place)."""
        from repro_torch.models import transformer as tfm
        b = token.shape[0]
        if specs is None:
            specs = cache_specs(cache, self.cfg, self.mesh, b)
        bspec = self.batch_spec(b)
        with torch.no_grad():
            logits, _ = tfm.decode_step(
                self.local_params(params), self.cfg, local_tree(cache),
                self.local_rows(token, bspec), index, tp=self.tp(b, specs))
        return self.rows_dtensor(logits, b, bspec), cache


# each (mesh, config)'s MeshModel, keyed by the mesh's identity and
# dropped with it
_MODELS: Dict[Tuple[int, ModelConfig], MeshModel] = {}


def mesh_model(model, mesh) -> MeshModel:
    """``model``'s :class:`MeshModel` on ``mesh``, made once."""
    key = (id(mesh), model.cfg)
    if key not in _MODELS:
        _MODELS[key] = MeshModel(model, mesh)
        weakref.finalize(mesh, _MODELS.pop, key, None)
    return _MODELS[key]


def mesh_of(params: Any):
    """The mesh ``params`` are stored on (their embedding a DTensor), or
    ``None``."""
    emb = params.get("embed") if isinstance(params, dict) else None
    return emb.device_mesh if isinstance(emb, DTensor) else None
