"""Flat-npz checkpointing with JSON metadata (step, config, reputation
state), in the reference's format (``repro.checkpoint``): nested dicts,
lists and tuples of tensors are flattened with ``/``-joined key paths
(dict keys, then list/tuple positions) into ``arrays.npz``, and
``metadata.json`` holds ``step``, ``n_arrays`` and the caller's
metadata, so an fp32 checkpoint written by either package restores in
the other. Restore rebuilds into a template tree (shapes checked), in
the template's dtypes and on its devices.

numpy has no bfloat16: a bf16 leaf is stored as its uint16 bit pattern,
and ``metadata.json`` records every leaf's dtype under ``"dtypes"``, so a
bf16 leaf restores bit for bit.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_BF16 = "bfloat16"


def _leaves(tree: Any, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[str, Any]]:
    """(key path, leaf) pairs in the reference's flattening order (dict
    keys sorted, as a JAX pytree flattens them)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _rebuild(template: Any, leaves: Iterator[Any]) -> Any:
    """``template``'s structure with its leaves taken from ``leaves`` in
    :func:`_leaves` order."""
    if isinstance(template, dict):
        out = {k: _rebuild(template[k], leaves) for k in sorted(template)}
        return {k: out[k] for k in template}
    if isinstance(template, (list, tuple)):
        items = [_rebuild(v, leaves) for v in template]
        if isinstance(template, list):
            return items
        return (type(template)(*items) if hasattr(template, "_fields")
                else tuple(items))
    return next(leaves)


def _encode(leaf: Any) -> Tuple[np.ndarray, str]:
    """(array to store, dtype name) of one leaf."""
    if torch.is_tensor(leaf):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16), _BF16
        arr = leaf.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def save_checkpoint(path: str, tree: Any, *, step: int = 0,
                    metadata: Optional[Dict[str, Any]] = None) -> None:
    os.makedirs(path, exist_ok=True)
    flat, dtypes = {}, {}
    for key, leaf in _leaves(tree):
        flat[key], dtypes[key] = _encode(leaf)
    np.savez(os.path.join(path, "arrays.npz"), **flat)
    meta = {"step": step, "n_arrays": len(flat), "dtypes": dtypes}
    meta.update(metadata or {})
    with open(os.path.join(path, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=2)


def _decode(arr: np.ndarray, dtype: Optional[str]) -> torch.Tensor:
    """The stored leaf as a tensor in its stored dtype."""
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore_checkpoint(path: str, template: Any
                       ) -> Tuple[Any, Dict[str, Any]]:
    """(tree shaped like ``template``, metadata). Raises ``KeyError`` for
    a leaf the checkpoint lacks and ``ValueError`` for a shape that
    differs from the template's."""
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        flat = {k: npz[k] for k in npz.files}
    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    dtypes = meta.get("dtypes", {})
    restored = []
    for key, leaf in _leaves(template):
        if key not in flat:
            raise KeyError(f"checkpoint missing array {key!r}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{key}: shape {arr.shape} != "
                             f"{tuple(leaf.shape)}")
        restored.append(_decode(arr, dtypes.get(key)).to(
            device=leaf.device, dtype=leaf.dtype))
    return _rebuild(template, iter(restored)), meta
