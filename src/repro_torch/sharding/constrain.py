"""Best-effort intermediate sharding constraints (the port's copy of
``repro/sharding/constrain.py``).

``constrain(x, {dim: axis})`` lays ``x`` out as the reference's
``with_sharding_constraint`` would against the *ambient* mesh (set with
:func:`use_mesh`, the counterpart of ``jax.set_mesh``) when a named axis
exists on it and divides the dimension; otherwise it is a no-op. The
reference also skips ``shard_map``-manual axes; the port has none. The
reference's constraint is total: every dimension it does not name is
replicated, and so here.

The port's serve steps compute on each rank's local shards with explicit
collectives (``models/parallel.py``), in the layout the reference's
``constrain`` sites ask GSPMD for; there ``x`` is a plain tensor and
``constrain`` returns it. On a ``DTensor`` on the ambient mesh it
redistributes to the reference's placements.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor

from repro_torch.sharding.placement import placements
from repro_torch.sharding.specs import Spec, axis_sizes

Axis = Union[str, Sequence[str]]

# the innermost use_mesh's mesh last
_AMBIENT: List[object] = []


@contextmanager
def use_mesh(mesh) -> Iterator[None]:
    """Make ``mesh`` (a ``DeviceMesh`` or a ``MeshShape``) the ambient
    mesh while open."""
    _AMBIENT.append(mesh)
    try:
        yield
    finally:
        _AMBIENT.pop()


def ambient_mesh():
    """The innermost :func:`use_mesh`'s mesh, or ``None``."""
    return _AMBIENT[-1] if _AMBIENT else None


def _usable_axes(mesh, axes: Axis) -> Tuple[Tuple[str, ...], int]:
    """The axes of ``axes`` present on the mesh, and the product of their
    sizes."""
    names = (axes,) if isinstance(axes, str) else tuple(axes)
    sizes = axis_sizes(mesh)
    out = tuple(a for a in names if a in sizes)
    return out, math.prod(sizes[a] for a in out)


def constrain_spec(shape: Sequence[int], dims: Dict[int, Axis],
                   mesh=None) -> Optional[Spec]:
    """The ``Spec`` the reference's ``constrain`` would apply to a tensor
    of ``shape`` on ``mesh`` (default: the ambient one), or ``None`` where
    it leaves the tensor as it is."""
    mesh = ambient_mesh() if mesh is None else mesh
    if mesh is None or not axis_sizes(mesh):
        return None
    ndim = len(shape)
    entries: list = [None] * ndim
    ok = False
    for d, ax in dims.items():
        d = d % ndim
        names, size = _usable_axes(mesh, ax)
        if not names or size <= 1:
            continue
        if shape[d] % size or shape[d] < size:
            continue
        entries[d] = names if len(names) > 1 else names[0]
        ok = True
    return Spec(*entries) if ok else None


def constrain(x: torch.Tensor, dims: Dict[int, Axis]) -> torch.Tensor:
    """``x`` laid out with ``dims[d]`` = axis name(s) on dim d, against
    the ambient mesh, best-effort: a ``DTensor`` on that mesh is
    redistributed to the reference's placements; a plain tensor, a
    ``DTensor`` on another mesh, or no ambient mesh returns ``x``."""
    mesh = ambient_mesh()
    if mesh is None or not isinstance(x, DTensor) \
            or x.device_mesh is not mesh:
        return x
    spec = constrain_spec(tuple(x.shape), dims)
    if spec is None:
        return x
    place = placements(spec, mesh)
    if list(x.placements) == place:
        return x
    return x.redistribute(mesh, place)
