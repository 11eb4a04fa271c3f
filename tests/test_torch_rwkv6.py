"""The port's RWKV6 family (``rwkv6-1.6b``) against the JAX reference on
identical inputs: the config field by field and its weights held,
``models.rwkv6`` (the time mix: its two-level scan over 64-token chunks,
the decode step) and ``mlp``'s channel mix, the serving path (the
one-forward prefill's state and logits against the reference's T decode
steps, then decode steps) and ``Model.grad_fn``, at reduced widths
(d_model 64, 4 heads of 16; weights from the port's seeded init, carried
to the reference with ``repro_torch.convert``).

T = 150 crosses two chunk boundaries and ends in a ragged chunk of 22:
the reference zero-pads that chunk (its padded steps decay S to 0), so
the state after position T-1 is held against T reference decode steps,
which the reference's own prefill is.

Tolerances (fp32 on the CPU): configs and greedy tokens exact;
``rwkv6_forward`` and ``channel_mix_forward`` 1e-5 relative (one layer:
the bonus term u·k·r is summed apart from S^T r, and the matmuls in
another order); logits, the decode state and gradients 1e-4 relative
(norm of the difference over the norm of the reference), the contract
the port holds everywhere.
"""
import dataclasses
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import mlp as jmlp
from repro.models import rwkv6 as jrwkv6
from repro.models.model import Model as JModel
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _torch_zoo import (RefDecoder, assert_trees, port_tokens, rel, tree_np,
                        weights)
from repro_torch import convert
from repro_torch.configs import get_arch, reduced
from repro_torch.models import mlp, rwkv6
from repro_torch.models import transformer as tfm
from repro_torch.models.model import Model
from repro_torch.tree import tree_leaves

ARCH = "rwkv6-1.6b"
T, MAX_LEN, STEPS = 150, 160, 4
GRAD_CHUNK = 64


def _cfgs(layers=2):
    return (jreduced(jget_arch(ARCH), d_model=64, layers=layers),
            reduced(get_arch(ARCH), d_model=64, layers=layers))


def _layer_params(seed):
    """One "W" layer's mixer and channel mix from the port's init, and
    their copies for the reference."""
    _, cfg = _cfgs()
    gen = torch.Generator().manual_seed(seed)
    tp = {"mixer": rwkv6.init_rwkv6(gen, cfg),
          "ffn": mlp.init_channel_mix(gen, cfg)}
    # a decay that varies: w0 from the reference's -5 spread over [-7, 1]
    tp["mixer"]["w0"] = torch.linspace(-7.0, 1.0, cfg.d_model)
    jp = jax.tree.map(lambda x: jnp.asarray(x.numpy()), tp)
    return cfg, tp, jp


# ---------------------------------------------------------------------------
# config

def test_rwkv6_config_matches_reference():
    """The full published config and its reduced variants, field by
    field, with every property and method."""
    j, t = jget_arch(ARCH), get_arch(ARCH)
    for jc, tc in ((j, t), (jreduced(j), reduced(t)),
                   (jreduced(j, d_model=64, layers=3),
                    reduced(t, d_model=64, layers=3))):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        for prop in ("resolved_head_dim", "is_encdec", "subquadratic",
                     "n_moe_layers"):
            assert getattr(tc, prop) == getattr(jc, prop), prop
        for meth in ("layer_types", "param_count", "active_param_count"):
            assert getattr(tc, meth)() == getattr(jc, meth)(), meth
    assert t.param_count() == 1_375_928_320
    assert t.citation and t.citation == j.citation


def test_rwkv6_weights_held():
    """The port holds the reference's leaves, shape for shape; at full
    width the reference holds 1,483,180,032 weights where its analytic
    ``param_count()`` gives 1,375,928,320 (a "W" layer's decay LoRA, w0,
    u and mixes counted 2·d, its channel mix as a dense FFN without w_r
    and its mixes, and no ``final_norm``); the port's
    ``transformer.param_count`` counts what it holds."""
    jc, tc = _cfgs(3)
    shapes = jax.eval_shape(JModel(jc).init, jax.random.PRNGKey(1))
    tp = Model(tc).init(1, device="cpu")
    got = jax.tree.map(np.shape, convert.model_params_to_numpy(tp, tc))
    assert got == jax.tree.map(lambda s: s.shape, shapes)
    held = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert tfm.param_count(tp) == held

    full = jax.eval_shape(JModel(jget_arch(ARCH)).init,
                          jax.random.PRNGKey(1))
    n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(full))
    d = 2048
    per_layer_extra = 132 * d + d * d + 2 * d
    assert n == 1_483_180_032 == 1_375_928_320 + 24 * per_layer_extra + d


# ---------------------------------------------------------------------------
# the layers

@pytest.mark.parametrize("t", [T, 1])
def test_rwkv6_forward_and_channel_mix_match_reference(t):
    """The time mix over T = 150 (two whole chunks and a ragged one) and
    over one token, and the channel mix with and without a carried
    ``prev``."""
    cfg, tp, jp = _layer_params(0)
    jcfg, _ = _cfgs()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, t, cfg.d_model)).astype(np.float32)
    prev = rng.standard_normal((2, cfg.d_model)).astype(np.float32)
    want = jax.jit(lambda p, a: jrwkv6.rwkv6_forward(p, a, jcfg))(
        jp["mixer"], jnp.asarray(x))
    got = rwkv6.rwkv6_forward(tp["mixer"], torch.tensor(x), cfg)
    assert rel(got.numpy(), want) <= 1e-5
    for p in (None, prev):
        want = jmlp.channel_mix_forward(
            jp["ffn"], jnp.asarray(x),
            None if p is None else jnp.asarray(p))
        got = mlp.channel_mix_forward(
            tp["ffn"], torch.tensor(x), None if p is None else torch.tensor(p))
        assert rel(got.numpy(), want) <= 1e-5


def test_rwkv6_prefill_state_and_decode_match_reference_steps():
    """``rwkv6_prefill``'s state after position T-1 against T reference
    decode steps, then 3 decode steps of each from that state."""
    cfg, tp, jp = _layer_params(1)
    jcfg, _ = _cfgs()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, T + 3, cfg.d_model)).astype(np.float32)
    step = jax.jit(lambda p, a, s: jrwkv6.rwkv6_decode(p, a, s, jcfg))
    st_j = jrwkv6.init_rwkv6_state(jcfg, 2)
    ys_j = []
    for i in range(T):
        y, st_j = step(jp["mixer"], jnp.asarray(x[:, i:i + 1]), st_j)
        ys_j.append(np.asarray(y))
    y_t, st_t = rwkv6.rwkv6_prefill(tp["mixer"], torch.tensor(x[:, :T]), cfg)
    assert rel(y_t.numpy(), np.concatenate(ys_j, 1)) <= 1e-5
    assert rel(st_t["S"].numpy(), st_j["S"]) <= 1e-5
    assert np.array_equal(st_t["prev"].numpy(), np.asarray(st_j["prev"]))
    for i in range(T, T + 3):
        y_j, st_j = step(jp["mixer"], jnp.asarray(x[:, i:i + 1]), st_j)
        y_t, st_t = rwkv6.rwkv6_decode(tp["mixer"],
                                       torch.tensor(x[:, i:i + 1]), st_t, cfg)
        assert rel(y_t.numpy(), y_j) <= 1e-5
        assert rel(st_t["S"].numpy(), st_j["S"]) <= 1e-5


# ---------------------------------------------------------------------------
# the model

def test_rwkv6_serving_matches_reference():
    """``Model.prefill`` (one forward) against the reference's T decode
    steps: the last logits and every leaf of the state ({"rec": {"S",
    "prev"}, "ffn_prev"} a layer; the converter carries the reference's
    back in the port's tree); ``forward_hidden`` against the port's
    prefill at every position; 4 greedy decode steps; the state's size
    independent of T."""
    jcfg, cfg = _cfgs()
    tp, jp = weights(cfg, 0)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, T)).astype(np.int32)
    ref = RefDecoder(jcfg, jp)
    ttok = port_tokens(prompt)
    lg_j, c_j = ref.prefill(prompt, MAX_LEN)
    lg_t, c_t = Model(cfg).prefill(tp, {"tokens": ttok}, MAX_LEN)
    assert rel(lg_t.numpy(), lg_j) <= 1e-4
    assert sorted(c_t["layers"][0]) == ["ffn_prev", "rec"]
    assert sorted(c_t["layers"][0]["rec"]) == ["S", "prev"]
    assert_trees(convert.model_cache_to_numpy(c_t, cfg), tree_np(c_j), 1e-4)
    back = convert.model_cache_from_numpy(tree_np(c_j), cfg, device="cpu")
    assert jax.tree.structure(back) == jax.tree.structure(c_t)
    h_t, aux, off = tfm.forward_hidden(tp, cfg, {"tokens": ttok})
    assert off == 0 and float(aux) == 0.0
    h_p, _ = tfm.prefill_hidden(tp, cfg, ttok, MAX_LEN)
    assert torch.equal(h_t, h_p)

    tok_j, tok_t = jnp.asarray(prompt[:, -1]), ttok[:, -1]
    for i in range(STEPS):
        l_j, c_j = ref.decode(c_j, tok_j, T + i)
        l_t, c_t = tfm.decode_step(tp, cfg, c_t, tok_t, T + i)
        assert rel(l_t.numpy(), l_j) <= 1e-4, i
        tok_j, tok_t = jnp.argmax(l_j, -1), torch.argmax(l_t, -1)
        assert np.array_equal(tok_t.numpy(), np.asarray(tok_j)), i
    assert_trees(convert.model_cache_to_numpy(c_t, cfg), tree_np(c_j), 1e-4)

    # a constant-size state: the same leaves after 3 tokens or T + 4
    _, short = Model(cfg).prefill(tp, {"tokens": ttok[:, :3]}, MAX_LEN)
    sizes = [(x.shape, x.dtype) for x in jax.tree.leaves(short)]
    assert sizes == [(x.shape, x.dtype) for x in jax.tree.leaves(c_t)]
    assert sizes == [(x.shape, x.dtype) for x in jax.tree.leaves(
        Model(cfg).init_cache(tp, 2, MAX_LEN))]


def test_rwkv6_grads_match_reference():
    """``Model.grad_fn`` against ``jax.value_and_grad`` of the reference
    loss on the same weights and batch (2 x 150 tokens, chunk 64): the
    loss and every gradient leaf; the port rematerializes each 64-token
    chunk of the scan, as the reference's ``jax.checkpoint`` does. Then
    the same with every layer rematerialized too: equal."""
    jcfg, cfg = _cfgs()
    tp, jp = weights(cfg, 3)
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, T)).astype(np.int32)
    (l_j, m_j), g_j = jax.jit(JModel(jcfg).grad_fn(GRAD_CHUNK))(
        jp, {"tokens": jnp.asarray(tokens)})
    (l_t, m_t), g_t = Model(cfg).grad_fn(GRAD_CHUNK)(
        tp, {"tokens": port_tokens(tokens)})
    assert abs(float(l_t) - float(l_j)) <= 1e-5 * abs(float(l_j))
    assert float(m_t["aux_loss"]) == float(m_j["aux_loss"]) == 0.0
    worst = assert_trees(convert.model_params_to_numpy(g_t, cfg),
                         tree_np(g_j), 1e-4)
    print(f"rwkv6: loss {float(l_t):.6f} vs {float(l_j):.6f}, worst grad "
          f"leaf {worst:.2e}")
    # every layer rematerialized (the routing and the chunks run again in
    # the backward): the same loss and gradients, bit for bit
    (l_r, _), g_r = Model(replace(cfg, remat=True)).grad_fn(GRAD_CHUNK)(
        tp, {"tokens": port_tokens(tokens)})
    assert float(l_r) == float(l_t)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(g_r), tree_leaves(g_t)))
