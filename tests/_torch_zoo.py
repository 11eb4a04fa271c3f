"""Helpers of the model-zoo tests that hold the port against the JAX
reference (``test_torch_moe.py``, ``test_torch_rwkv6.py``,
``test_torch_whisper.py``, ``test_torch_paligemma.py``): relative
errors, weights carried from the port's seeded init to the reference,
tree comparison, and the reference's decode-step prefill with its decode
step and its encoder compiled once. Not a test module (leading
underscore)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro_torch import convert
from repro_torch.models.model import Model


def rel(got, want) -> float:
    """‖got − want‖ / ‖want‖ in float64."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def to_jax(tp, cfg):
    """The port's params (or grads) as the reference's tree of jnp
    arrays."""
    return jax.tree.map(lambda x: jnp.asarray(np.array(x)),
                        convert.model_params_to_numpy(tp, cfg))


def weights(cfg, seed):
    """The port's seeded weights and a copy of them in the reference's
    tree (the port's init spares the reference's, which runs op by op)."""
    tp = Model(cfg).init(seed, device="cpu")
    return tp, to_jax(tp, cfg)


def ref_kept(params, x, cfg):
    """The reference's routing (``repro/models/moe.py:56-79``) restated
    in JAX: the (expert, token) pairs its ``lax.top_k(combine.T, cap)``
    keeps with a weight > 0, and the count of routed pairs."""
    b, t, d = x.shape
    xt = x.reshape(b * t, d)
    probs = jax.nn.softmax((xt @ params["router"]).astype(jnp.float32), -1)
    top_p, top_e = jax.lax.top_k(probs, cfg.top_k)
    top_p = top_p / jnp.maximum(top_p.sum(-1, keepdims=True), 1e-9)
    combine = jax.vmap(lambda c, i, p: c.at[i].add(p))(
        jnp.zeros(probs.shape, jnp.float32), top_e, top_p)
    gate, idx = jax.lax.top_k(combine.T, jmoe.moe_capacity(cfg, b * t))
    gate, idx = np.asarray(gate), np.asarray(idx)
    return ({(e, int(idx[e, c])) for e, c in zip(*np.nonzero(gate > 0))},
            int((np.asarray(combine) > 0).sum()))


def assert_trees(got, want, tol) -> float:
    """Every leaf of the numpy tree ``got`` within ``tol`` relative of
    ``want``'s; integer leaves (``pos``) exactly equal. Returns the
    worst relative error."""
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    got_leaves = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(got_leaves) == len(want_leaves)
    worst = 0.0
    for path, w in want_leaves:
        g = got_leaves[path]
        name = jax.tree_util.keystr(path)
        assert g.shape == w.shape, name
        if np.issubdtype(w.dtype, np.integer):
            assert np.array_equal(g, w), name
        else:
            err = rel(g, w)
            assert err <= tol, (name, err)
            worst = max(worst, err)
    return worst


class RefDecoder:
    """The reference's ``Model.prefill`` restated as the loop its
    ``lax.scan`` runs (``init_cache``, an encoder-decoder's holding the
    encoded frames' cross-attention keys and values, then
    ``transformer.decode_step`` at positions 0..T-1), with the decode
    step jitted once and reused for the greedy steps after the prompt,
    and the encoder (``transformer.encode``) jitted once."""

    def __init__(self, jcfg, jparams):
        self.cfg, self.params = jcfg, jparams
        self.step = jax.jit(
            lambda p, c, t, i: jtfm.decode_step(p, jcfg, c, t, i))
        self._encode = jax.jit(lambda p, f: jtfm.encode(p, jcfg, f))

    def encode(self, frames: np.ndarray):
        return self._encode(self.params, jnp.asarray(frames))

    def prefill(self, tokens: np.ndarray, max_len: int, memory=None):
        b, t = tokens.shape
        cache = jtfm.init_cache(self.params, self.cfg, b, max_len,
                                memory=memory)
        logits = None
        for i in range(t):
            logits, cache = self.step(self.params, cache,
                                      jnp.asarray(tokens[:, i]),
                                      jnp.asarray(i))
        return logits, cache

    def decode(self, cache, token, index: int):
        return self.step(self.params, cache, token, jnp.asarray(index))


def port_tokens(tokens: np.ndarray) -> torch.Tensor:
    return torch.tensor(tokens).long()
