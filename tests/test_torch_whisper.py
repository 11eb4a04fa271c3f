"""The port's encoder-decoder family (``whisper-small``) against the JAX
reference on identical inputs: the config field by field and its weights
held, ``common.layer_norm`` and ``sinusoidal_positions``, the three
cross-attention functions, the encoder (``Model.encode``),
``forward_hidden``, the loss and ``Model.grad_fn`` with frames, and the
serving path (the one-forward prefill's logits and whole cache, the
cross-attention keys and values included, against the reference's T
decode steps, then greedy decode steps), at reduced widths: d_model 64,
4 heads of 16, 2 encoder and 2 decoder layers, 16 frames, with
``rope_theta`` put back to 0.0 (``reduced`` sets RoPE), so the
sinusoidal positions run on both sides. Weights are the port's seeded
init carried to the reference with ``repro_torch.convert``; the frames
come from the port's ``dummy_batch``.

Tolerances (fp32 on the CPU): configs, ``pos`` tags, shapes and greedy
tokens exact; ``layer_norm`` and one cross-attention 1e-5 relative
(libm and matmul order); the sinusoids 1e-4 relative and 2e-4 absolute
of the float64 values (the fp32 angle p·div rounds by up to 6e-5 at
p = 1499, and the two libraries' fp32 ``exp`` differ by an ulp in some
columns); the model's logits, caches,
hidden states, loss and gradients 1e-4 relative (norm of the difference
over the norm of the reference), the contract the port holds
everywhere.
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
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import transformer as jtfm
from repro.models.model import Model as JModel
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _torch_zoo import (RefDecoder, assert_trees, port_tokens, rel, tree_np,
                        weights)
from repro_torch import convert
from repro_torch.configs import get_arch, reduced
from repro_torch.models import attention, common
from repro_torch.models import transformer as tfm
from repro_torch.models.model import Model
from repro_torch.tree import tree_leaves, tree_map

ARCH = "whisper-small"
B, T, MAX_LEN, STEPS = 2, 24, 32, 4
GRAD_CHUNK = 12


def _cfgs():
    return (replace(jreduced(jget_arch(ARCH), d_model=64), rope_theta=0.0),
            replace(reduced(get_arch(ARCH), d_model=64), rope_theta=0.0))


JCFG, CFG = _cfgs()


@pytest.fixture(scope="module")
def zoo():
    """The port's seed-0 weights and their reference copy, a batch of B
    prompts of T tokens with frames, and the reference's decoder (its
    decode step and encoder compiled once for the module)."""
    tp, jp = weights(CFG, 0)
    batch = Model(CFG).dummy_batch(0, B, T)
    return dict(tp=tp, jp=jp, batch=batch, ref=RefDecoder(JCFG, jp),
                jbatch={k: jnp.asarray(v.numpy()) for k, v in batch.items()})


# ---------------------------------------------------------------------------
# config

def test_whisper_config_matches_reference():
    """The full published config and its reduced variants, field by
    field, with every property and method."""
    j, t = jget_arch(ARCH), get_arch(ARCH)
    for jc, tc in ((j, t), (jreduced(j), reduced(t)), _cfgs()):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        for prop in ("resolved_head_dim", "is_encdec", "subquadratic",
                     "n_moe_layers"):
            assert getattr(tc, prop) == getattr(jc, prop), prop
        for meth in ("layer_types", "param_count", "active_param_count"):
            assert getattr(tc, meth)() == getattr(jc, meth)(), meth
    assert t.is_encdec and t.enc_layers == 12 and t.enc_frames == 1500
    assert t.rope_theta == 0.0 and reduced(t).rope_theta == 10000.0
    assert t.param_count() == 238_068_480
    assert t.citation and t.citation == j.citation


def test_whisper_weights_held():
    """The port holds the reference's leaves, shape for shape (the
    encoder's layers unstacked); at full width the reference holds
    238,060,800 weights where its analytic ``param_count()`` gives
    238,068,480: it counts 4·d of norms an encoder layer where the layer
    holds 2·d, no decoder layer's ``norm_x`` (d) and neither final norm
    (2·d)."""
    shapes = jax.eval_shape(JModel(JCFG).init, jax.random.PRNGKey(1))
    tp = Model(CFG).init(1, device="cpu")
    assert sorted(tp["encoder"]) == ["final_norm", "layers"]
    assert len(tp["encoder"]["layers"]) == CFG.enc_layers
    assert sorted(tp["layers"][0]) == ["cross", "ffn", "mixer", "norm1",
                                       "norm2", "norm_x"]
    got = jax.tree.map(np.shape, convert.model_params_to_numpy(tp, CFG))
    assert got == jax.tree.map(lambda s: s.shape, shapes)
    held = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert tfm.param_count(tp) == held

    full = jax.eval_shape(JModel(jget_arch(ARCH)).init, jax.random.PRNGKey(1))
    n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(full))
    d = 768
    assert n == 238_060_800 == (238_068_480 - 12 * 2 * d + 12 * d + 2 * d)


# ---------------------------------------------------------------------------
# the layers

def test_sinusoids_and_layer_norm_match_reference():
    """``sinusoidal_positions`` (sin in the even columns, cos in the odd
    ones) at the encoder's and the decoder's lengths, against the
    reference and against float64, its row ``index`` as the decode step
    adds it, and ``layer_norm`` in fp32 and bf16."""
    for length, dim in ((16, 64), (1500, 768), (448, 768)):
        got = common.sinusoidal_positions(length, dim).numpy()
        want = np.asarray(jcommon.sinusoidal_positions(length, dim))
        assert got.shape == want.shape == (length, dim)
        assert rel(got, want) <= 1e-4, (length, dim)
        ang = np.arange(length)[:, None] * np.exp(
            -np.log(10000.0) * np.arange(0, dim, 2) / dim)
        exact = np.stack([np.sin(ang), np.cos(ang)], -1).reshape(length, dim)
        for table in (got, want):
            assert np.abs(table - exact).max() <= 2e-4, (length, dim)
        row = common.sinusoid_at(torch.tensor([length - 1]), dim).numpy()
        assert np.array_equal(row[0], got[length - 1])
    rng = np.random.default_rng(0)
    x = (3.0 + 2.0 * rng.standard_normal((2, 5, 64))).astype(np.float32)
    w = (1.0 + 0.1 * rng.standard_normal(64)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(64)).astype(np.float32)
    want = jcommon.layer_norm(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(bias))
    got = common.layer_norm(torch.tensor(x), torch.tensor(w),
                            torch.tensor(bias))
    assert rel(got.numpy(), want) <= 1e-5
    got16 = common.layer_norm(torch.tensor(x).bfloat16(), torch.tensor(w),
                              torch.tensor(bias))
    want16 = jcommon.layer_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w),
                                jnp.asarray(bias))
    assert got16.dtype == torch.bfloat16
    assert rel(got16.float().numpy(), np.asarray(want16, np.float32)) <= 1e-2


def test_cross_attention_matches_reference():
    """``cross_attn_forward`` (T queries over F frames, no mask),
    ``init_cross_cache`` and ``cross_attn_decode`` of one query, with a
    softcap on in the config that cross-attention must not apply."""
    cfg = replace(CFG, attn_softcap=5.0)
    jcfg = replace(JCFG, attn_softcap=5.0)
    gen = torch.Generator().manual_seed(3)
    tp = attention.init_attn(gen, cfg)
    jp = {k: jnp.asarray(v.numpy()) for k, v in tp.items()}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 7, cfg.d_model)).astype(np.float32)
    mem = (3.0 * rng.standard_normal((B, 16, cfg.d_model))).astype(np.float32)
    want = jattn.cross_attn_forward(jp, jnp.asarray(x), jnp.asarray(mem),
                                    cfg=jcfg)
    got = attention.cross_attn_forward(tp, torch.tensor(x), torch.tensor(mem),
                                       cfg=cfg)
    assert rel(got.numpy(), want) <= 1e-5
    jc = jattn.init_cross_cache(jp, jnp.asarray(mem), jcfg)
    tc = attention.init_cross_cache(tp, torch.tensor(mem), cfg)
    assert sorted(tc) == ["k", "v"]
    for k in ("k", "v"):
        assert tc[k].shape == (B, 16, cfg.n_kv_heads, cfg.resolved_head_dim)
        assert rel(tc[k].numpy(), jc[k]) <= 1e-5
    want = jattn.cross_attn_decode(jp, jnp.asarray(x[:, :1]), jc, cfg=jcfg)
    got = attention.cross_attn_decode(tp, torch.tensor(x[:, :1]), tc, cfg=cfg)
    assert rel(got.numpy(), want) <= 1e-5
    # the same as the full-sequence path's first query
    first = attention.cross_attn_forward(tp, torch.tensor(x[:, :1]),
                                         torch.tensor(mem), cfg=cfg)
    assert rel(got.numpy(), first.numpy()) <= 1e-6


# ---------------------------------------------------------------------------
# the model

def test_whisper_encode_and_forward_match_reference(zoo):
    """``Model.encode`` (sinusoids, bidirectional layers, the RMS final
    norm) and ``forward_hidden`` with frames (offset 0, the decoder's
    sinusoids over S)."""
    tp, jp, batch, jb = zoo["tp"], zoo["jp"], zoo["batch"], zoo["jbatch"]
    assert batch["frames"].shape == (B, CFG.enc_frames, CFG.d_model)
    mem_j = zoo["ref"].encode(batch["frames"].numpy())
    mem_t = Model(CFG).encode(tp, batch["frames"])
    assert mem_t.shape == (B, 16, 64)
    assert rel(mem_t.numpy(), mem_j) <= 1e-4
    h_j, aux_j, off_j = jax.jit(lambda p, b: jtfm.forward_hidden(
        p, JCFG, b))(jp, jb)
    h_t, aux_t, off_t = tfm.forward_hidden(tp, CFG, batch)
    assert off_t == int(off_j) == 0 and float(aux_t) == 0.0
    assert rel(h_t.numpy(), h_j) <= 1e-4
    # the frames reach the text: other frames, other hidden states
    other = dict(batch, frames=2.0 * batch["frames"])
    assert rel(tfm.forward_hidden(tp, CFG, other)[0].numpy(),
               h_t.numpy()) > 1e-3


def test_whisper_grads_match_reference(zoo):
    """``Model.loss`` and ``Model.grad_fn`` against
    ``jax.value_and_grad`` of the reference loss with frames: the loss
    and every gradient leaf, the encoder's and the cross-attention's
    included; then with every decoder layer rematerialized: equal."""
    tp, jp, batch, jb = zoo["tp"], zoo["jp"], zoo["batch"], zoo["jbatch"]
    (l_j, _), g_j = jax.jit(JModel(JCFG).grad_fn(GRAD_CHUNK))(jp, jb)
    (l_t, m_t), g_t = Model(CFG).grad_fn(GRAD_CHUNK)(tp, batch)
    assert abs(float(l_t) - float(l_j)) <= 1e-5 * abs(float(l_j))
    loss, met = Model(CFG).loss(tp, batch, GRAD_CHUNK)
    assert float(loss) == float(l_t)
    assert float(met["aux_loss"]) == float(m_t["aux_loss"]) == 0.0
    worst = assert_trees(convert.model_params_to_numpy(g_t, CFG),
                         tree_np(g_j), 1e-4)
    enc = g_t["encoder"]["layers"][0]["mixer"]["wq"]
    cross = g_t["layers"][1]["cross"]["wk"]
    assert float(enc.abs().max()) > 0 and float(cross.abs().max()) > 0
    print(f"whisper: loss {float(l_t):.6f} vs {float(l_j):.6f}, worst grad "
          f"leaf {worst:.2e}")
    (l_r, _), g_r = Model(replace(CFG, remat=True)).grad_fn(GRAD_CHUNK)(
        tp, batch)
    assert float(l_r) == float(l_t)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(g_r), tree_leaves(g_t)))


def test_whisper_serving_matches_reference(zoo):
    """``Model.prefill`` (the frames encoded, then one full-sequence
    forward) against the reference's T decode steps from an
    ``init_cache`` holding the encoded frames: the last logits and every
    cache leaf (``attn`` k, v, pos and ``cross`` k, v); 4 greedy decode
    steps; the converter both ways; and T decode steps of the port's own
    from ``init_cache(memory=...)`` equal to its one-forward prefill."""
    tp, jp, batch, ref = zoo["tp"], zoo["jp"], zoo["batch"], zoo["ref"]
    prompt = batch["tokens"].numpy().astype(np.int32)
    mem_j = ref.encode(batch["frames"].numpy())
    lg_j, c_j = ref.prefill(prompt, MAX_LEN, memory=mem_j)
    lg_t, c_t = Model(CFG).prefill(tp, batch, MAX_LEN)
    assert rel(lg_t.numpy(), lg_j) <= 1e-4
    assert sorted(c_t["layers"][0]) == ["attn", "cross"]
    assert c_t["layers"][0]["cross"]["k"].shape == (B, 16, 4, 16)
    assert_trees(convert.model_cache_to_numpy(c_t, CFG), tree_np(c_j), 1e-4)
    back = convert.model_cache_from_numpy(tree_np(c_j), CFG, device="cpu")
    assert jax.tree.structure(back) == jax.tree.structure(c_t)
    pback = convert.model_params_from_numpy(
        convert.model_params_to_numpy(tp, CFG), CFG, device="cpu")
    assert jax.tree.structure(pback) == jax.tree.structure(tp)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(pback),
                                                 tree_leaves(tp)))

    # decode steps from init_cache(memory=...) fill the same cache
    model = Model(CFG)
    mem_t = model.encode(tp, batch["frames"])
    c_s = model.init_cache(tp, B, MAX_LEN, memory=mem_t)
    ttok = port_tokens(prompt)
    for i in range(T):
        lg_s, c_s = tfm.decode_step(tp, CFG, c_s, ttok[:, i], i)
    assert rel(lg_s.numpy(), lg_t.numpy()) <= 1e-5
    for a, b in zip(tree_leaves(c_s), tree_leaves(c_t)):
        if a.is_floating_point():
            assert rel(a.numpy(), b.numpy()) <= 1e-5
        else:
            assert torch.equal(a, b)
    # without memory the cross cache is zeros of enc_frames frames
    empty = model.init_cache(tp, B, MAX_LEN)["layers"][0]["cross"]["k"]
    assert empty.shape == (B, 16, 4, 16) and not empty.any()

    c_t = tree_map(lambda x: x.clone(), c_t)
    tok_j, tok_t = jnp.asarray(prompt[:, -1]), ttok[:, -1]
    for i in range(STEPS):
        l_j, c_j = ref.decode(c_j, tok_j, T + i)
        l_t, c_t = tfm.decode_step(tp, CFG, c_t, tok_t, T + i)
        assert rel(l_t.numpy(), l_j) <= 1e-4, i
        tok_j, tok_t = jnp.argmax(l_j, -1), torch.argmax(l_t, -1)
        assert np.array_equal(tok_t.numpy(), np.asarray(tok_j)), i
    assert_trees(convert.model_cache_to_numpy(c_t, CFG), tree_np(c_j), 1e-4)


def test_whisper_bf16_prefill_and_decode_against_fp32(zoo):
    """bf16 weights (the frames cast to them in the encoder) against the
    port's own fp32 run from the same weights: the prefill's logits and
    cross cache and 4 decode steps' logits within bf16's rounding (the
    reference cannot prefill in bf16)."""
    tp, batch = zoo["tp"], zoo["batch"]
    tb = tree_map(lambda x: x.to(torch.bfloat16), tp)
    model = Model(CFG)
    lg32, c32 = model.prefill(tp, batch, MAX_LEN)
    lg16, c16 = model.prefill(tb, batch, MAX_LEN)
    assert lg16.dtype == torch.bfloat16
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(c16)
               if x.is_floating_point())
    assert rel(lg16.float().numpy(), lg32.numpy()) <= 5e-2
    assert rel(c16["layers"][1]["cross"]["v"].float().numpy(),
               c32["layers"][1]["cross"]["v"].numpy()) <= 5e-2
    tok = batch["tokens"][:, -1]
    for i in range(STEPS):
        l32, c32 = tfm.decode_step(tp, CFG, c32, tok, T + i)
        l16, c16 = tfm.decode_step(tb, CFG, c16, tok, T + i)
        assert torch.isfinite(l16).all()
        assert rel(l16.float().numpy(), l32.numpy()) <= 5e-2, i
        tok = torch.argmax(l32, -1)
