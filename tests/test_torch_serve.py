"""The port's serving path of ``recurrentgemma-2b`` against the JAX
reference on identical inputs: weights from the reference's own init,
converted (``repro_torch.convert``); inputs from numpy with a seed.

The configuration is the full model's layout at a small width:
``replace(reduced(recurrentgemma-2b, d_model=128, layers=3),
num_layers=8)`` — two stacked R, R, L cycles and a tail of two R layers
(the reference's ``scanned`` and ``tail`` groups both occur), window 64.

Tolerances, all in fp32 on the CPU, with their reasons:
* configs, cache ``pos`` tags, converted trees, greedy tokens: exact;
* ``rms_norm``, ``softcap``, ``apply_rope``: 1e-6 (the same formulas;
  libm differences only);
* one block (RG-LRU, attention, FFN): 1e-5 (the recurrence runs as
  another scan — Hillis–Steele here, XLA's associative scan or the
  Pallas kernel's sequential loop there — and matmuls sum in another
  order);
* the 8-layer model (hidden states, prefill logits and every cache leaf,
  decode logits): 1e-4 relative (norm of the difference over the norm of
  the reference), the contract the port holds everywhere.
"""
import dataclasses
from dataclasses import replace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import rglru as jrglru
from repro.models import transformer as jtfm
from repro.models.model import Model as JModel
from repro.serve.decode import greedy_generate as jgreedy_generate
from repro.serve.decode import make_prefill_step as jmake_prefill_step
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs.base import ModelConfig, get_arch, reduced
from repro_torch.launch import serve as serve_mod
from repro_torch.models import attention, common, mlp, rglru
from repro_torch.models import transformer as tfm
from repro_torch.models.model import Model, build_model
from repro_torch.serve.decode import (greedy_generate, make_prefill_step,
                                      make_serve_step)

T_PROMPT, MAX_LEN = 96, 104          # T > window 64: the ring wraps


def _cfgs():
    j = replace(jreduced(jget_arch("recurrentgemma-2b"), d_model=128,
                         layers=3), num_layers=8)
    t = replace(reduced(get_arch("recurrentgemma-2b"), d_model=128,
                        layers=3), num_layers=8)
    return j, t


JCFG, CFG = _cfgs()


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _t(a, dtype=None):
    t = torch.tensor(np.asarray(a))
    return t if dtype is None else t.to(dtype)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_trees(got, want, tol):
    """Every leaf of ``got`` (numpy) within ``tol`` relative of
    ``want``'s; integer leaves (``pos``) exactly equal."""
    want_leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    got_leaves = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(got_leaves) == len(want_leaves)
    for path, w in want_leaves:
        g = got_leaves[path]
        name = jax.tree_util.keystr(path)
        assert g.shape == w.shape, name
        if np.issubdtype(w.dtype, np.integer):
            assert np.array_equal(g, w), name
        else:
            assert _rel(g, w) <= tol, (name, _rel(g, w))


@pytest.fixture(scope="module")
def weights():
    """(reference params, port params) from the reference's init."""
    jp = JModel(JCFG).init(jax.random.PRNGKey(0))
    return jp, convert.model_params_from_numpy(_tree_np(jp), CFG,
                                               device="cpu")


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(0).integers(
        0, CFG.vocab_size, (2, T_PROMPT)).astype(np.int32)


# ---------------------------------------------------------------------------
# configs

def test_model_config_fields_and_defaults_match_reference():
    jf = [(f.name, f.default) for f in dataclasses.fields(jbase.ModelConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(ModelConfig)]
    assert tf == jf
    assert tbase.ATTN_BLOCKS == jbase.ATTN_BLOCKS


@pytest.mark.parametrize("variant", ["full", "reduced", "test", "smoke"])
def test_recurrentgemma_config_and_properties_match_reference(variant):
    j, t = jget_arch("recurrentgemma-2b"), get_arch("recurrentgemma-2b")
    if variant == "reduced":
        j, t = jreduced(j, d_model=128, layers=5), reduced(t, d_model=128,
                                                           layers=5)
    elif variant == "test":
        j, t = JCFG, CFG
    elif variant == "smoke":
        j, t = jreduced(j), build_model("recurrentgemma-2b", smoke=True).cfg
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for prop in ("resolved_head_dim", "is_encdec", "subquadratic",
                 "n_moe_layers"):
        assert getattr(t, prop) == getattr(j, prop), prop
    for meth in ("layer_types", "param_count", "active_param_count"):
        assert getattr(t, meth)() == getattr(j, meth)(), meth
    assert [t.is_moe_layer(i) for i in range(t.num_layers)] == \
        [j.is_moe_layer(i) for i in range(j.num_layers)]


def test_full_width_layout_and_true_parameter_count():
    cfg = get_arch("recurrentgemma-2b")
    assert cfg.layer_types().count("R") == 18
    assert cfg.layer_types().count("L") == 8
    assert cfg.param_count() == 2_658_411_520
    # the analytic count gives an R layer's gates, conv and Λ 3·rd, where
    # the layer holds w_a, w_i (2·rd²), conv_w (W·rd = 4·rd) and Λ (rd),
    # and it leaves out final_norm (d)
    def held(c, n_r):
        rd = c.rg_lru_dim or c.d_model
        return c.param_count() + n_r * (2 * rd ** 2 + 2 * rd) + c.d_model
    assert held(cfg, 18) == 2_894_435_840
    # the port's held count on the test config equals the reference's
    jp = JModel(JCFG).init(jax.random.PRNGKey(1))
    n_ref = sum(np.asarray(x).size for x in jax.tree.leaves(jp))
    p = Model(CFG).init(1, device="cpu")
    assert tfm.param_count(p) == n_ref
    assert n_ref == held(CFG, 6)


def test_unported_arch_and_layers_raise():
    """What the port still refuses, naming the missing feature: a
    placement the tensor-parallel code does not compute, by leaf and dim
    (every family serves over a mesh, ``tests/test_torch_mesh_serve.py``;
    these are placements no published configuration produces: ``wq`` or
    ``wk`` cut on head_dim, the FFN cut on D, the RG-LRU's ``w_in`` cut on
    D, RWKV6's ``w_o`` cut on its columns, a cross-attention's ``wq`` cut
    on head_dim). Every registered arch builds, one-token attention over
    a cache of more than 2^20 slots runs (chunk by chunk) and equals the
    whole-cache softmax, and ``make_plain_step`` takes a mesh
    (``tests/test_torch_train.py``)."""
    from repro_torch.models import rwkv6
    from repro_torch.models.parallel import TP, Axis, Groups
    from repro_torch.sharding import Spec

    with pytest.raises(KeyError, match="unknown arch 'no-such-arch'"):
        get_arch("no-such-arch")
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 1, 1, 1, 4, generator=gen)
    big = torch.randn(1, 1, 1, 4, generator=gen).expand(
        1, (1 << 20) + 1, 1, 4)
    valid = torch.ones((1 << 20) + 1, dtype=torch.bool)
    got = attention._decode_attn(q, big, big, valid, 0.0)
    want = attention._sdpa(q, big, big, valid[None, None, None, None], 0.0)
    assert torch.allclose(got, want, rtol=1e-5, atol=0.0)
    # a leaf cut where the code does not compute it, on 2 model ranks (it
    # raises before any collective)
    cfg = reduced(get_arch("gemma2-2b"))
    lp = Model(cfg).init(0, device="cpu")["layers"][0]
    x = torch.zeros((1, 1, cfg.d_model))
    groups = Groups(Axis(None, 0, 2), Axis(None, 0, 1), ("data",))
    for leaf, spec, call in (
            ("wq", Spec(None, None, "model"),
             lambda tp: attention.attn_forward(lp["mixer"], x, cfg=cfg,
                                               layer_type="A", tp=tp)),
            ("wk", Spec(None, None, "model"),
             lambda tp: attention.attn_forward(lp["mixer"], x, cfg=cfg,
                                               layer_type="A", tp=tp)),
            ("w_up", Spec("model", None),
             lambda tp: mlp.mlp_forward(lp["ffn"], x, cfg, tp=tp)),
            ("wq", Spec(None, None, "model"),
             lambda tp: attention.cross_attn_forward(
                 lp["mixer"], x, x, cfg=cfg, tp=tp))):
        specs = {"wq": Spec(None, "model", None),
                 "wo": Spec("model", None, None),
                 "w_gate": Spec(None, "model"),
                 "w_down": Spec("model", None), leaf: spec}
        dim = next(i for i, e in enumerate(spec) if e == "model")
        with pytest.raises(NotImplementedError,
                           match=rf"{leaf} cut over 'model' on dim {dim}"):
            call(TP(groups, specs))
    rg = CFG
    rp = Model(rg).init(0, device="cpu")["layers"][0]["mixer"]
    xr = torch.zeros((1, 2, rg.d_model))
    with pytest.raises(NotImplementedError,
                       match=r"w_in cut over 'model' on dim 0"):
        rglru.rglru_prefill(rp, xr, rg,
                            tp=TP(groups, {"w_in": Spec("model", None)}))
    rw = reduced(get_arch("rwkv6-1.6b"))
    wp = Model(rw).init(0, device="cpu")["layers"][0]["mixer"]
    xw = torch.zeros((1, 2, rw.d_model))
    with pytest.raises(NotImplementedError,
                       match=r"w_o cut over 'model' on dim 1"):
        rwkv6.rwkv6_prefill(wp, xw, rw,
                            tp=TP(groups, {"w_o": Spec(None, "model")}))


def test_init_on_cuda_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Model(CFG).init(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_mod.serve("recurrentgemma-2b", smoke=True, requests=1)


def test_init_is_seeded_and_truncated():
    a = Model(CFG).init(3, device="cpu")
    b = Model(CFG).init(3, device="cpu")
    c = Model(CFG).init(4, device="cpu")
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], c["embed"])
    w = a["layers"][0]["mixer"]["w_in"]         # std 1/sqrt(128), |w| <= 2σ
    assert float(w.abs().max()) <= 2.0 / np.sqrt(128) + 1e-7
    assert abs(float(w.std()) * np.sqrt(128) - 0.88) < 0.05
    assert a["layers"][0]["mixer"]["w_a"].shape == (128, 128)
    bf = Model(CFG).init(3, device="cpu", dtype="bfloat16")
    assert all(x.dtype == torch.bfloat16
               for x in jax.tree.leaves(bf["layers"][2]))


# ---------------------------------------------------------------------------
# common

@pytest.mark.parametrize("seed", [0, 1])
def test_common_helpers_match_reference(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 7, 3, 32)).astype(np.float32)
    w = (0.1 * rng.standard_normal(32)).astype(np.float32)
    _close(common.rms_norm(_t(x), _t(w)),
           jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w)), 1e-6)
    _close(common.rms_norm(_t(x), _t(w), gemma_style=False),
           jcommon.rms_norm(jnp.asarray(x), jnp.asarray(w),
                            gemma_style=False), 1e-6)
    big = 40.0 * x
    _close(common.softcap(_t(big), 30.0),
           jcommon.softcap(jnp.asarray(big), 30.0), 1e-6)
    assert torch.equal(common.softcap(_t(big), 0.0), _t(big))
    pos = rng.integers(0, 200, 7)
    _close(common.apply_rope(_t(x), _t(pos), 10000.0),
           jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0),
           1e-6)
    g = 3.0 * x
    _close(common.gelu(_t(g)), jax.nn.gelu(jnp.asarray(g)), 1e-6)


def test_bf16_embedding_scale_is_rounded_first():
    """sqrt(2560) = 50.596 is 50.5 in bf16; the reference multiplies by
    the rounded scalar."""
    cfg = get_arch("recurrentgemma-2b")
    emb = torch.ones(4, 8, dtype=torch.bfloat16)
    x = tfm._embed({"embed": emb}, cfg, torch.tensor([[1]]))
    assert float(x[0, 0, 0]) == 50.5
    jx = jtfm._embed({"embed": jnp.ones((4, 8), jnp.bfloat16)}, cfg,
                     jnp.asarray([[1]]))
    assert float(jx[0, 0, 0]) == 50.5


# ---------------------------------------------------------------------------
# blocks

@pytest.mark.parametrize("act", ["geglu", "swiglu", "gelu"])
def test_mlp_forward_matches_reference(act):
    jc, tc = replace(JCFG, ffn_act=act), replace(CFG, ffn_act=act)
    jp = jmlp.init_mlp(jax.random.PRNGKey(2), jc)
    x = np.random.default_rng(2).standard_normal((2, 5, 128)).astype(
        np.float32)
    got = mlp.mlp_forward({k: _t(v) for k, v in jp.items()}, _t(x), tc)
    _close(got, jmlp.mlp_forward(jp, jnp.asarray(x), jc), 1e-5)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("t", [1, 2, 24, 70])
def test_rglru_forward_matches_reference(use_kernel, t):
    """Against the associative scan and the Pallas kernel in interpret
    mode. For T = 1, 2 < W-1 = 3 the reference runs T = 3 and the first
    T rows are compared (the block is causal): the reference pads its
    conv with min(T, W-1) zero rows, so its full forward holds for
    T >= W-1 only."""
    jp = jrglru.init_rglru(jax.random.PRNGKey(3), JCFG)
    x = np.random.default_rng(t).standard_normal((2, max(t, 3), 128)
                                                 ).astype(np.float32)
    want = jrglru.rglru_forward(jp, jnp.asarray(x), JCFG,
                                use_kernel=use_kernel)
    tp = {k: _t(v) for k, v in jp.items()}
    got = rglru.rglru_forward(tp, _t(x[:, :t]), CFG)
    # causal: the first t rows of a longer sequence are the t-row answer
    _close(got, np.asarray(want)[:, :t], 1e-5)


def test_rglru_scan_with_carried_state_matches_reference():
    rng = np.random.default_rng(4)
    a = rng.uniform(0.5, 0.99, (2, 17, 8)).astype(np.float32)
    b = rng.standard_normal((2, 17, 8)).astype(np.float32)
    h0 = rng.standard_normal((2, 8)).astype(np.float32)
    _close(rglru.rglru_scan(_t(a), _t(b), _t(h0)),
           jrglru.rglru_scan(jnp.asarray(a), jnp.asarray(b),
                             jnp.asarray(h0)), 1e-5)


def test_rglru_prefill_state_and_decode_match_reference():
    """The prefill state (last scan row, last W-1 conv inputs) equals the
    state the reference's one-step decode reaches token by token, and
    decoding on from it matches."""
    jp = jrglru.init_rglru(jax.random.PRNGKey(5), JCFG)
    tp = {k: _t(v) for k, v in jp.items()}
    x = np.random.default_rng(5).standard_normal((2, 12, 128)).astype(
        np.float32)
    step = jax.jit(partial(jrglru.rglru_decode, cfg=JCFG))
    st = jrglru.init_rglru_state(JCFG, 2)
    for i in range(10):
        _, st = step(jp, jnp.asarray(x[:, i:i + 1]), state=st)
    _, tst = rglru.rglru_prefill(tp, _t(x[:, :10]), CFG)
    for k in ("h", "conv"):
        _close(tst[k], st[k], 1e-5)
    for i in range(10, 12):
        y_j, st = step(jp, jnp.asarray(x[:, i:i + 1]), state=st)
        y_t, tst = rglru.rglru_decode(tp, _t(x[:, i:i + 1]), tst, CFG)
        _close(y_t, y_j, 1e-5)
        for k in ("h", "conv"):
            _close(tst[k], st[k], 1e-5)


@pytest.mark.parametrize("layer_type", ["L", "A"])
def test_attn_forward_matches_reference(layer_type):
    """T = 160, q_chunk = 32, window 64: the band slicing runs for "L"
    (band 96 < 160) and the query padding for q_chunk 48."""
    jp = jattn.init_attn(jax.random.PRNGKey(6), JCFG)
    tp = {k: _t(v) for k, v in jp.items()}
    x = np.random.default_rng(6).standard_normal((2, 160, 128)).astype(
        np.float32)
    for q_chunk in (32, 48):
        want = jattn.attn_forward(jp, jnp.asarray(x), cfg=JCFG,
                                  layer_type=layer_type, q_chunk=q_chunk)
        got = attention.attn_forward(tp, _t(x), cfg=CFG,
                                     layer_type=layer_type, q_chunk=q_chunk)
        _close(got, want, 1e-5)


@pytest.mark.parametrize("layer_type", ["L", "A"])
def test_attn_prefill_cache_and_decode_match_reference(layer_type):
    """70 one-token decode steps from an empty cache (the window ring of
    64 wraps), against the reference step by step; and the prefill of the
    first 66 positions leaves the cache those steps left."""
    jp = jattn.init_attn(jax.random.PRNGKey(7), JCFG)
    tp = {k: _t(v) for k, v in jp.items()}
    x = np.random.default_rng(7).standard_normal((2, 70, 128)).astype(
        np.float32)
    max_len = 80
    step = jax.jit(partial(jattn.attn_decode, cfg=JCFG,
                           layer_type=layer_type))
    jc = jattn.init_attn_cache(JCFG, layer_type, 2, max_len)
    tc = attention.init_attn_cache(CFG, layer_type, 2, max_len)
    for i in range(70):
        y_j, jc = step(jp, jnp.asarray(x[:, i:i + 1]), jc, jnp.asarray(i))
        y_t, tc = attention.attn_decode(tp, _t(x[:, i:i + 1]), tc, i,
                                        cfg=CFG, layer_type=layer_type)
        _close(y_t, y_j, 1e-5)
        if i == 65:
            _, pc = attention.attn_prefill(tp, _t(x[:, :66]), cfg=CFG,
                                           layer_type=layer_type,
                                           max_len=max_len)
            assert np.array_equal(pc["pos"].numpy(), np.asarray(jc["pos"]))
            for k in ("k", "v"):
                _close(pc[k], jc[k], 1e-5)
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))


# ---------------------------------------------------------------------------
# the model

def test_forward_hidden_and_prefill_step_match_reference(weights, prompt):
    jp, tp = weights
    batch = {"tokens": jnp.asarray(prompt)}
    h_j, _, off = jtfm.forward_hidden(jp, JCFG, batch)
    h_t, aux, off_t = tfm.forward_hidden(tp, CFG,
                                         {"tokens": _t(prompt).long()})
    assert off_t == off == 0 and float(aux) == 0.0
    assert _rel(h_t.numpy(), h_j) <= 1e-4
    lg_j = jmake_prefill_step(JModel(JCFG), None, batch=2)(jp, batch)
    lg_t = make_prefill_step(Model(CFG), None)(
        tp, {"tokens": _t(prompt).long()})
    assert _rel(lg_t.numpy(), lg_j) <= 1e-4


@pytest.mark.parametrize("t", [T_PROMPT, 2])
def test_prefill_matches_reference_prefill(weights, prompt, t):
    """The port's one full-sequence forward against the reference's T
    decode steps (``repro.models.model.Model.prefill``): last logits and
    every cache leaf within 1e-4 relative, ``pos`` exact. T = 96 > window
    wraps the ring; T = 2 < W-1 zero-pads the conv state."""
    jp, tp = weights
    toks = prompt[:, :t]
    lg_j, c_j = JModel(JCFG).prefill(jp, {"tokens": jnp.asarray(toks)},
                                     MAX_LEN)
    lg_t, c_t = Model(CFG).prefill(tp, {"tokens": _t(toks).long()}, MAX_LEN)
    assert _rel(lg_t.numpy(), lg_j) <= 1e-4
    _assert_trees(convert.model_cache_to_numpy(c_t, CFG), _tree_np(c_j),
                  1e-4)
    # and one decode step on from there
    tok = np.argmax(np.asarray(lg_j), -1).astype(np.int32)
    l1_j, c1_j = jtfm.decode_step(jp, JCFG, c_j, jnp.asarray(tok),
                                  jnp.asarray(t))
    l1_t, c1_t = tfm.decode_step(tp, CFG, c_t, _t(tok).long(), t)
    assert _rel(l1_t.numpy(), l1_j) <= 1e-4
    _assert_trees(convert.model_cache_to_numpy(c1_t, CFG), _tree_np(c1_j),
                  1e-4)


def test_decode_steps_from_an_empty_cache_equal_the_one_forward_prefill(
        weights, prompt):
    """The reference's prefill route run in the port (``init_cache``, then
    T ``serve_step`` calls) against the port's one-forward prefill at
    T = 70 > window: last logits and every cache leaf within 1e-4
    relative, ``pos`` exact."""
    tp = weights[1]
    model = Model(CFG)
    step, _ = make_serve_step(model)
    toks = _t(prompt[:, :70]).long()
    cache = model.init_cache(tp, 2, MAX_LEN)
    for i in range(70):
        logits, cache = step(tp, cache, toks[:, i], i)
    lg, pc = model.prefill(tp, {"tokens": toks}, MAX_LEN)
    assert _rel(lg.numpy(), logits.numpy()) <= 1e-4
    _assert_trees(convert.model_cache_to_numpy(pc, CFG),
                  convert.model_cache_to_numpy(cache, CFG), 1e-4)


def test_prefill_rejects_a_prompt_longer_than_the_cache(weights, prompt):
    with pytest.raises(ValueError, match="max_len"):
        Model(CFG).prefill(weights[1], {"tokens": _t(prompt).long()}, 64)


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype) if tree.is_floating_point() else tree


def test_bf16_prefill_and_decode_against_fp32(weights, prompt):
    """What the bf16 serve path is held to: the port in bf16 against the
    port in fp32 on the same weights (the bf16 weights upcast), the
    prefill of T = 96 tokens (the ring wraps) and 16 greedy decode steps,
    the fp32 run fed the bf16 run's tokens.

    The reference cannot be the oracle here: its ``Model.prefill`` raises
    a ``lax.scan`` carry-dtype TypeError on bf16 weights at both cache
    dtypes (with the default fp32 cache the layer carry goes bf16 → f32,
    ``repro/models/transformer.py:259`` from the scan body at
    ``repro/models/model.py:62-66``; with a bf16 cache the f32 logits
    carry set up at ``model.py:68-70`` comes back bf16), and its launcher
    serves fp32 only (``repro/launch/serve.py:49``, ``model.init(key)``).

    Tolerance: the bf16 contract, 5e-2 relative, on every step's logits
    (measured 1.4–2.2e-2: bf16 keeps 8 bits of mantissa, 4e-3 a rounding,
    over 8 layers). A greedy token may differ only where the fp32 run's
    top two logits lie within twice the step's largest logit error
    (measured: all 17 agree)."""
    jp, tp = weights
    jbf = jax.tree.map(lambda x: x.astype(jnp.bfloat16)
                       if jnp.issubdtype(x.dtype, jnp.floating) else x, jp)
    for cache_dtype in (jnp.float32, jnp.bfloat16):
        with pytest.raises(TypeError, match="carry"):
            JModel(JCFG).prefill(jbf, {"tokens": jnp.asarray(prompt[:, :8])},
                                 16, cache_dtype=cache_dtype)
    bf = _cast(tp, torch.bfloat16)
    up = _cast(bf, torch.float32)
    model = Model(CFG)
    t = T_PROMPT
    toks = _t(prompt).long()
    lb, cb = model.prefill(bf, {"tokens": toks}, t + 16)
    lf, cf = model.prefill(up, {"tokens": toks}, t + 16)
    assert lb.dtype == torch.bfloat16 and lf.dtype == torch.float32
    errs, agree = [], 0
    for i in range(17):
        lbf = lb.float()
        errs.append(_rel(lbf.numpy(), lf.numpy()))
        tok = torch.argmax(lbf, -1)
        same = tok == torch.argmax(lf, -1)
        top2 = torch.topk(lf, 2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        bound = 2 * torch.max(torch.abs(lbf - lf), dim=-1).values
        assert bool((same | (gap <= bound)).all()), i
        agree += int(same.all())
        if i < 16:
            lb, cb = tfm.decode_step(bf, CFG, cb, tok, t + i)
            lf, cf = tfm.decode_step(up, CFG, cf, tok, t + i)
    print(f"bf16 against fp32: logits {min(errs):.2e}–{max(errs):.2e} "
          f"relative; greedy tokens agree at {agree} of 17 steps")
    assert max(errs) <= 5e-2, errs


def test_greedy_generate_matches_reference(weights, prompt):
    jp, tp = weights
    want = jgreedy_generate(JModel(JCFG), jp, jnp.asarray(prompt), 8,
                            MAX_LEN)
    got = greedy_generate(Model(CFG), tp, _t(prompt).long(), 8, MAX_LEN)
    assert got.shape == (2, T_PROMPT + 8)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_converter_round_trip(weights, prompt):
    jp, tp = weights
    back = convert.model_params_to_numpy(tp, CFG)
    _assert_trees(back, _tree_np(jp), 0.0)
    assert len(tp["layers"]) == 8 and len(jp["scanned"]) == 3 \
        and len(jp["tail"]) == 2
    _, c_j = JModel(JCFG).prefill(jp, {"tokens": jnp.asarray(prompt[:, :8])},
                                  16)
    c_t = convert.model_cache_from_numpy(_tree_np(c_j), CFG, device="cpu")
    assert c_t["layers"][2]["attn"]["pos"].dtype == torch.int32
    _assert_trees(convert.model_cache_to_numpy(c_t, CFG), _tree_np(c_j), 0.0)
    bf = convert.model_params_from_numpy(_tree_np(jp), CFG, device="cpu",
                                         dtype=torch.bfloat16)
    assert bf["layers"][7]["ffn"]["w_up"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# the launcher

def test_serve_smoke_on_cpu_serves_every_request():
    res = serve_mod.serve("recurrentgemma-2b", smoke=True, batch=2,
                          requests=5, prompt_len=16, gen=4, device="cpu")
    assert sorted(r.rid for r in res.requests) == list(range(5))
    vocab = reduced(get_arch("recurrentgemma-2b")).vocab_size
    for r in res.requests:
        assert r.done and len(r.generated) == 4
        assert all(0 <= tok < vocab for tok in r.generated)
    assert res.finite and res.decode_steps == 20
    assert res.n_params == tfm.param_count(
        build_model("recurrentgemma-2b", smoke=True).init(0, device="cpu"))


def test_serve_is_the_reference_loop_on_given_prompts(monkeypatch, prompt):
    """Passed-in prompts at the test configuration, one slot: each
    request's tokens equal the reference launcher's loop (prefill argmax,
    then greedy one-token decode steps) run by the reference on the
    port's seed-0 weights."""
    gen, t = 4, 24
    monkeypatch.setattr(serve_mod, "build_model",
                        lambda arch, smoke=False: Model(CFG))
    prompts = [torch.tensor(prompt[i, :t]).long() for i in range(2)]
    res = serve_mod.serve("recurrentgemma-2b", batch=1, requests=2,
                          prompt_len=t, gen=gen, device="cpu",
                          prompts=prompts)
    assert [r.rid for r in res.requests] == [0, 1]
    jp = jax.tree.map(jnp.asarray, convert.model_params_to_numpy(
        Model(CFG).init(0, device="cpu"), CFG))
    for r in res.requests:
        toks = jnp.asarray(prompt[r.rid:r.rid + 1, :t])
        logits, cache = JModel(JCFG).prefill(jp, {"tokens": toks}, t + gen)
        tok, want = int(jnp.argmax(logits[0])), []
        for i in range(gen):
            logits, cache = jtfm.decode_step(jp, JCFG, cache,
                                             jnp.asarray([tok]),
                                             jnp.asarray(t + i))
            tok = int(jnp.argmax(logits[0]))
            want.append(tok)
        assert r.generated == want
    for bad in (t - 1, t + 1):
        with pytest.raises(ValueError, match="prompt_len - vis_tokens"):
            serve_mod.serve("recurrentgemma-2b", batch=1, requests=2,
                            prompt_len=t, gen=gen, device="cpu",
                            prompts=[torch.tensor(prompt[i, :bad]).long()
                                     for i in range(2)])


def test_serve_cli_main(capsys):
    serve_mod.main(["--arch", "recurrentgemma-2b", "--smoke", "--device",
                    "cpu", "--requests", "2", "--batch", "2",
                    "--prompt-len", "8", "--gen", "3"])
    out = capsys.readouterr().out
    assert "served 2 requests, 6 decode steps" in out
