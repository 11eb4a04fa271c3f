"""The port's checkpoints (``repro_torch.checkpoint``) against the
reference's (``repro.checkpoint``): the same format (``/``-joined key
paths in ``arrays.npz``, ``metadata.json``), so an fp32 checkpoint
written by either package restores in the other; bf16 leaves, which
numpy cannot hold, round-trip bit for bit as their uint16 patterns; a
missing leaf raises ``KeyError`` and a shape that differs from the
template's ``ValueError``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint


def _tree(seed: int = 0):
    """A nested dict / list / tuple of fp32 tensors (the shapes of a
    server's state: params, reputation, a stacked layer group)."""
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    return {"params": {"fc2_w": r(128, 10), "fc2_b": r(10),
                       "conv1_w": r(3, 3, 3, 32)},
            "rep": torch.rand(90, generator=g),
            "layers": [r(2, 4), (r(3,), r(1, 1))]}


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _jax(tree):
    if isinstance(tree, dict):
        return {k: _jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_jax(v) for v in tree)
    return jnp.asarray(tree.numpy())


def test_port_checkpoint_restores_in_reference(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path / "ck"), tree, step=7,
                    metadata={"arch": "cnn"})
    zeros = _jax(_tree(1))
    got, meta = jrestore(str(tmp_path / "ck"), zeros)
    assert meta["step"] == 7 and meta["arch"] == "cnn"
    assert meta["n_arrays"] == 7
    for a, b in zip(_leaves(got), _leaves(tree)):
        assert a.dtype == jnp.float32
        assert np.array_equal(np.asarray(a), b.numpy())


def test_reference_checkpoint_restores_in_port(tmp_path):
    tree = _tree()
    jsave(str(tmp_path / "ck"), _jax(tree), step=3,
          metadata={"rounds": 5})
    got, meta = restore_checkpoint(str(tmp_path / "ck"), _tree(1))
    assert meta["step"] == 3 and meta["rounds"] == 5
    assert isinstance(got["layers"], list)
    assert isinstance(got["layers"][1], tuple)
    assert list(got["params"]) == list(tree["params"])
    for a, b in zip(_leaves(got), _leaves(tree)):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def test_bf16_round_trip_bit_exact(tmp_path):
    g = torch.Generator().manual_seed(2)
    w = (torch.randn(64, 33, generator=g) * 1e3).to(torch.bfloat16)
    special = torch.tensor([0.0, -0.0, float("inf"), float("-inf"),
                            float("nan"), 1e-40, -3.0e38],
                           dtype=torch.bfloat16)
    tree = {"w": w, "special": special, "f32": torch.ones(3)}
    save_checkpoint(str(tmp_path / "ck"), tree)
    template = {"w": torch.zeros_like(w), "special": torch.zeros(7,
                dtype=torch.bfloat16), "f32": torch.zeros(3)}
    got, meta = restore_checkpoint(str(tmp_path / "ck"), template)
    assert meta["dtypes"] == {"f32": "float32", "special": "bfloat16",
                              "w": "bfloat16"}
    for k in ("w", "special"):
        assert got[k].dtype == torch.bfloat16
        assert torch.equal(got[k].view(torch.int16),
                           tree[k].view(torch.int16)), k
    # into an fp32 template: the exact widening of the stored bf16
    got32, _ = restore_checkpoint(str(tmp_path / "ck"),
                                  {"w": torch.zeros(64, 33),
                                   "special": torch.zeros(7),
                                   "f32": torch.zeros(3)})
    assert torch.equal(got32["w"], w.float())


def test_shape_mismatch_and_missing_leaf_raise(tmp_path):
    save_checkpoint(str(tmp_path / "ck"), {"a": torch.zeros(3),
                                           "b": [torch.zeros(2, 2)]})
    with pytest.raises(ValueError, match="b/0"):
        restore_checkpoint(str(tmp_path / "ck"),
                           {"a": torch.zeros(3), "b": [torch.zeros(2, 3)]})
    with pytest.raises(KeyError, match="c"):
        restore_checkpoint(str(tmp_path / "ck"),
                           {"a": torch.zeros(3), "c": torch.zeros(1)})
