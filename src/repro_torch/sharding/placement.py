"""Storage by spec: the port's form of a ``NamedSharding``-placed global
array is a ``DTensor`` on a live ``DeviceMesh``.

A :class:`~repro_torch.sharding.specs.Spec` entry naming axes puts
``Shard(dim)`` on each of those mesh dims; a tuple entry such as
``("pod", "data")`` shards one tensor dim over several mesh dims, major
to minor, which is how JAX cuts it: the device at mesh coordinate
(p, d) holds chunk p·|data| + d. Every rank holds the whole tensor
before it is sharded (the same seed draws the same weights on every
rank), so :func:`shard_tree` cuts its own slice locally and moves no
bytes."""
from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.sharding.specs import Spec, axis_sizes
from repro_torch.tree import tree_map

Tensor = torch.Tensor


def _entry_axes(entry) -> Tuple[str, ...]:
    return () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))


def placements(spec: Spec, mesh) -> List[Any]:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that an entry of tensor dim d names, ``Replicate()`` on the
    others."""
    names = list(axis_sizes(mesh))
    out: List[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"{spec!r} names axis {a!r}; the mesh has "
                                 f"{names}")
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"{spec!r}: dim {d} lists {axes} against the "
                             f"mesh's order {names}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"{spec!r} uses axis {names[i]!r} twice")
            out[i] = Shard(d)
    return out


def local_slices(shape: Sequence[int], spec: Spec, mesh,
                 coord: Dict[str, int]) -> Tuple[slice, ...]:
    """The slice of a ``shape`` tensor held at mesh coordinate ``coord``
    ({axis: index}) under ``spec``: dim d's entry splits it into
    Π sizes equal chunks, the axes' indices read major to minor."""
    sizes = axis_sizes(mesh)
    out = []
    for d, n in enumerate(shape):
        axes = _entry_axes(spec[d]) if d < len(spec) else ()
        parts = math.prod(sizes[a] for a in axes)
        if n % parts:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                             f"into {parts} under {spec!r}")
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + coord[a]
        chunk = n // parts
        out.append(slice(idx * chunk, (idx + 1) * chunk))
    return tuple(out)


def _coord(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))


def _contiguous_stride(shape: Sequence[int]) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def shard(x: Tensor, spec: Spec, mesh) -> DTensor:
    """``x`` stored by ``spec`` on the live ``mesh``: a whole tensor (the
    same on every rank) is cut locally, a copy of this rank's slice; a
    DTensor is redistributed if its placements differ."""
    place = placements(spec, mesh)
    if isinstance(x, DTensor):
        if list(x.placements) == place:
            return x
        return x.redistribute(mesh, place)
    sl = local_slices(x.shape, spec, mesh, _coord(mesh))
    local = x if all(s == slice(0, n) for s, n in zip(sl, x.shape)) \
        else x[sl].clone()
    return DTensor.from_local(local, mesh, place, run_check=False,
                              shape=x.shape,
                              stride=_contiguous_stride(x.shape))


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    """Every leaf of ``tree`` stored by the matching leaf of ``specs``."""
    return tree_map(lambda x, s: shard(x, s, mesh), tree, specs)


def full_tree(tree: Any) -> Any:
    """Plain whole tensors from a tree of DTensors (an all-gather each,
    which every rank of the mesh must call); other leaves as they are."""
    return tree_map(lambda x: x.full_tensor() if isinstance(x, DTensor)
                    else x, tree)
