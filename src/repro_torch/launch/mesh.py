"""Mesh construction (the port's copy of ``repro/launch/mesh.py``).
Functions, not module constants, so importing touches no process group.

Axes: ``data`` = client cohorts (FL data parallelism), ``model`` =
tensor/FSDP parallelism, ``pod`` = cloud boundary (multi-pod only). A
live mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
ranks of the default group, one card a rank on the GPU (NCCL) or gloo on
the CPU; a shape-only one is a :class:`~repro_torch.sharding.MeshShape`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.federated.sharded import ensure_group
from repro_torch.sharding.specs import MeshShape


def debug_mesh_shape(n: int, multi_pod: bool = False) -> MeshShape:
    """The reference's small mesh over ``n`` devices: (2, n/4, 2) pod x
    data x model for multi-pod with n >= 8, (n/2, 2) for n >= 4, else
    (n, 1)."""
    if multi_pod and n >= 8:
        return MeshShape(("pod", "data", "model"), (2, n // 4, 2))
    if n >= 4:
        return MeshShape(("data", "model"), (n // 2, 2))
    return MeshShape(("data", "model"), (n, 1))


def live_mesh(shape: MeshShape, device: DeviceLike = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` over every rank of the default group,
    rank r at row-major position r. Starts a one-rank group when none is
    initialized and ``shape`` holds one rank (the caller ends it with
    ``dist.destroy_process_group()``)."""
    dev = resolve_device(device)
    n = math.prod(shape.sizes)
    if not dist.is_initialized() and n == 1:
        ensure_group(dev)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world:
        raise ValueError(f"a mesh of shape {shape.shape} holds {n} ranks; "
                         f"this process group has {world}")
    if dev.type == "cuda":       # NCCL's communicators take this rank's card
        torch.cuda.set_device(dev.index if dev.index is not None
                              else torch.cuda.current_device())
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape.sizes),
                      mesh_dim_names=shape.axis_names)


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[DeviceLike] = None):
    """The reference's TPU v5e production mesh, 16 x 16 (256 chips) a pod
    and 2 pods = 512, as a shape; with ``device``, a live mesh of that
    shape, which needs as many ranks."""
    shape = (MeshShape(("pod", "data", "model"), (2, 16, 16)) if multi_pod
             else MeshShape(("data", "model"), (16, 16)))
    if device is None:
        return shape
    n = math.prod(shape.sizes)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(f"the production mesh {shape.shape} needs {n} "
                         f"ranks, one a chip; this run has {world}: use "
                         f"make_debug_mesh")
    return live_mesh(shape, device)


def make_debug_mesh(n_devices: Optional[int] = None, multi_pod: bool = False,
                    *, device: DeviceLike = "cuda") -> DeviceMesh:
    """A live small mesh over the ranks that exist (``n_devices``, default
    the default group's size; without a group, one rank: see
    :func:`live_mesh`)."""
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    return live_mesh(debug_mesh_shape(n, multi_pod), device)
