"""Partition rules (the port's copy of ``repro/sharding/specs.py``): a
:class:`Spec` for every parameter, optimizer moment, batch leaf and
cache leaf of any arch on any mesh.

Parameter rule: name-based preferred-dimension lists (Megatron-style:
heads/d_ff/vocab/experts over ``model``), falling back to the
largest divisible dim; FSDP archs also shard one remaining dim over the
data axes. Tensors under 64 KiB in fp32 stay whole. Dims that interact
with the RoPE rotate-half trick (head_dim) come last.

The reference stacks layers (``scanned`` groups and the encoder's one
stack); the port keeps a list. A layer of a scanned group is judged at
its group's stacked size, as the reference judges the stacked leaf, and
a ``tail`` layer at its own. The reference does not mark the encoder's
stack as scanned, so its rules may put an axis on that stack's layer
dim; a per-layer tensor cannot hold a share of the layers, so the port
records that entry as ``Spec.layer`` and keeps each such layer whole
along that axis (whisper-small's encoder on the (4, 1), (2, 2) and
(1, 4) meshes).

Batch rule: the client/batch leading dim shards over ('pod','data');
batch-1 decode shards the KV-cache *sequence* dim over ``data`` instead.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` or a shape-only
:class:`MeshShape` (the reference's 16 x 16 TPU meshes, no ranks
behind them)."""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple, Union

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import layer_period
from repro_torch.optim import OptState
from repro_torch.tree import tree_map

Entry = Union[None, str, Tuple[str, ...]]

# preferred shard dims per parameter name (indices into the per-layer
# shape), tried in order; first divisible wins.
_PREFS: Dict[str, Tuple[int, ...]] = {
    "wq": (1, 0),          # (D, H, hd): heads, then D (row-parallel)
    "wk": (1, 0),
    "wv": (1, 0),
    "wo": (0, 2),          # (H, hd, D)
    "embed": (0, 1),       # (V, D)
    "lm_head": (1, 0),     # (D, V)
    "w_gate": (-1, 0),     # dense (D,F) / moe (E,D,F): last dim = F
    "w_up": (-1, 0),
    "w_down": (-2, -1),    # (F, D) / (E, F, D): F first
    "router": (1, 0),      # (D, E)
    "w_in": (1, 0), "w_out": (0, 1),
    "w_a": (1,), "w_i": (1,),
    "w_r": (1, 0), "w_k": (1, 0), "w_v": (0, 1), "w_o": (0, 1),
    "w_decay1": (0,), "w_decay2": (1,),
}
_MOE_PREFS = {"w_gate": (0, 2), "w_up": (0, 2), "w_down": (0, 1)}


class Spec:
    """A ``PartitionSpec`` in the reference's per-tensor-dimension form:
    an entry per dim, each ``None``, an axis name or a tuple of names
    (major to minor). ``Spec()`` keeps the tensor whole. ``layer`` is the
    entry the reference gives its layer stack's leading dim where that
    stack is not scanned (see the module's docstring), else ``None``. It
    compares entry for entry with a ``PartitionSpec`` or a tuple, and is
    a leaf of the port's trees (not a tuple itself)."""

    __slots__ = ("entries", "layer")

    def __init__(self, *entries: Entry, layer: Entry = None):
        self.entries = tuple(entries)
        self.layer = layer

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, Spec):
            return (self.entries, self.layer) == (other.entries, other.layer)
        if isinstance(other, str):
            return False
        try:
            entries = tuple(other)
        except TypeError:
            return NotImplemented
        return self.layer is None and self.entries == entries

    def __hash__(self) -> int:
        return hash((self.entries, self.layer))

    def __repr__(self) -> str:
        inner = ", ".join(repr(e) for e in self.entries)
        if self.layer is not None:
            inner += (", " if inner else "") + f"layer={self.layer!r}"
        return f"Spec({inner})"


@dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, no ranks behind them."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{len(self.axis_names)} axis names for "
                             f"{len(self.sizes)} sizes")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or a :class:`MeshShape`."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                       # a DeviceMesh
        return dict(zip(names, tuple(mesh.shape)))
    return dict(mesh.shape)


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))


def _data_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in data_axes(mesh))


def _pick(shape: Tuple[int, ...], prefs: Tuple[int, ...], size: int,
          taken: set) -> Optional[int]:
    ndim = len(shape)
    cands = [p % ndim for p in prefs] + sorted(
        range(ndim), key=lambda i: -shape[i])
    for c in cands:
        if c not in taken and shape[c] % size == 0 and shape[c] >= size:
            return c
    return None


def _leaf_entries(name: str, core: Tuple[int, ...], numel: int,
                  cfg: ModelConfig, mesh) -> Optional[list]:
    """The reference's ``spec_for`` on a leaf of shape ``core`` (its
    layer dim dropped where the reference scans it) holding ``numel``
    weights as the reference stores it: an entry per dim of ``core``, or
    ``None`` for a tensor kept whole."""
    if len(core) <= 1 or numel * 4 < 1 << 16:
        return None                        # small tensors: replicate
    sizes = axis_sizes(mesh)
    model_size = sizes.get("model", 1)
    daxes = data_axes(mesh)
    dsize = _data_size(mesh)
    assign: Dict[int, Any] = {}
    taken: set = set()
    prefs = _PREFS.get(name, ())
    if cfg.n_experts > 0 and name in _MOE_PREFS and len(core) == 3:
        prefs = _MOE_PREFS[name]
    if model_size > 1:
        m = _pick(core, prefs, model_size, taken)
        if m is not None:
            assign[m] = "model"
            taken.add(m)
    if cfg.fsdp and daxes and dsize > 1:
        d = _pick(core, tuple(p for p in prefs
                              if (p % len(core)) not in taken),
                  dsize, taken)
        if d is not None:
            assign[d] = daxes if len(daxes) > 1 else daxes[0]
            taken.add(d)
    return [assign.get(i, None) for i in range(len(core))]


def _named_map(fn, tree, name: str = ""):
    """``fn(key of the leaf's parent dict, leaf)`` over a tree's leaves."""
    if isinstance(tree, dict):
        return {k: _named_map(fn, tree[k], k) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [_named_map(fn, v, name) for v in tree]
    return None if tree is None else fn(name, tree)


def _spec(name: str, leaf, cfg: ModelConfig, mesh, times: int = 1,
          stack: int = 0) -> Spec:
    """``leaf``'s spec, judged as ``times`` stacked copies (a scanned
    group's layer); with ``stack``, as one layer of a stack of that many
    whose layer dim the rule reads (the encoder's): its entry becomes
    ``Spec.layer``."""
    core = tuple(leaf.shape)
    if stack:
        ent = _leaf_entries(name, (stack,) + core, stack * leaf.numel(), cfg,
                            mesh)
        return Spec() if ent is None else Spec(*ent[1:], layer=ent[0])
    ent = _leaf_entries(name, core, times * leaf.numel(), cfg, mesh)
    return Spec() if ent is None else Spec(*ent)


def param_specs(params: Any, cfg: ModelConfig, mesh) -> Any:
    """A tree of :class:`Spec` matching the port's ``params`` (tensors or
    :func:`Model.param_shapes`' meta tensors)."""
    depth = cfg.num_layers // layer_period(cfg)
    scanned = depth * layer_period(cfg)      # the reference scans [0, scanned)

    def layer(i, lp):
        times = depth if i < scanned else 1
        return _named_map(lambda name, x: _spec(name, x, cfg, mesh, times),
                          lp)

    out = {}
    for k in sorted(params):
        v = params[k]
        if k == "layers":
            out[k] = [layer(i, lp) for i, lp in enumerate(v)]
        elif k == "encoder":
            n = len(v["layers"])
            out[k] = _named_map(lambda name, x: _spec(name, x, cfg, mesh),
                                {"final_norm": v["final_norm"]})
            out[k]["layers"] = [
                _named_map(lambda name, x: _spec(name, x, cfg, mesh,
                                                 stack=n), lp)
                for lp in v["layers"]]
        else:
            out[k] = _spec(k, v, cfg, mesh)
    return out


def opt_state_specs(opt_state: OptState, params: Any, cfg: ModelConfig,
                    mesh) -> OptState:
    """ZeRO-1: optimizer moments follow the param sharding PLUS one extra
    dim sharded over the data axes where divisible (the update's
    gradient is whole on every data rank, so each can own a moment
    slice); the step counter stays whole."""
    pspecs = param_specs(params, replace(cfg, fsdp=True), mesh)
    step, mu, nu = opt_state

    def match(tree):
        return None if tree is None else tree_map(lambda _, s: s, tree,
                                                  pspecs)
    return OptState(Spec(), match(mu), match(nu))


def batch_specs(cfg: ModelConfig, mesh, batch_size: int) -> Spec:
    """Spec for a (B, ...) batch leaf: shard B over ('pod','data') when
    divisible, else replicate."""
    daxes = data_axes(mesh)
    dsize = _data_size(mesh)
    if daxes and batch_size % dsize == 0 and batch_size >= dsize:
        return Spec(daxes if len(daxes) > 1 else daxes[0])
    return Spec()


def tree_batch_specs(batch: Any, cfg: ModelConfig, mesh) -> Any:
    def spec_for(leaf):
        s = batch_specs(cfg, mesh, leaf.shape[0])
        return Spec(*(list(s) + [None] * (len(leaf.shape) - len(s))))
    return tree_map(spec_for, batch)


def cache_specs(cache: Any, cfg: ModelConfig, mesh, batch: int) -> Any:
    """KV caches: shard batch over data axes when divisible; otherwise
    shard the *sequence/state* dim (dim 1 for (B,S,KV,hd) attn caches,
    heads for rwkv state, feature dim for rglru state). The port's cache
    holds a dict a layer; the reference's rule reads each leaf without
    its stack's layer dim."""
    daxes = data_axes(mesh)
    dsize = _data_size(mesh)
    dax = daxes if len(daxes) > 1 else (daxes[0] if daxes else None)
    msize = axis_sizes(mesh).get("model", 1)

    def spec_for(name, leaf) -> Spec:
        core = tuple(leaf.shape)
        ent: list = [None] * len(core)
        if name == "pos" or len(core) < 2:
            pass
        elif core[0] % dsize == 0 and core[0] >= dsize and dsize > 1:
            ent[0] = dax                       # batch-sharded
            # additionally shard kv-heads (or head_dim when kv-heads do
            # not divide) over the model axis
            if name in ("k", "v") and len(core) == 4 and msize > 1:
                if core[2] % msize == 0 and core[2] >= msize:
                    ent[2] = "model"
                elif core[3] % msize == 0 and core[3] >= msize:
                    ent[3] = "model"
        elif dsize > 1 and core[1] % dsize == 0 and core[1] >= dsize:
            ent[1] = dax                       # sequence/state-sharded
        return Spec(*ent)

    return _named_map(spec_for, cache)
