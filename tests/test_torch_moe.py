"""The port's MoE family (``mixtral-8x7b``, ``llama4-maverick-400b-a17b``)
against the JAX reference on identical inputs: the configs field by
field, ``models.moe`` (routing, capacity, dispatch, the aux loss), and
the serving and training paths of both layouts at reduced widths
(weights from the port's seeded init, carried to the reference with
``repro_torch.convert``; prompts from numpy with a seed).

What the cases hold:

* ``moe_forward`` top-2 with drops (capacity factor 0.5), top-1 with
  drops (every routed weight exactly 1.0, so the kept tokens are decided
  by tie order: the reference's ``lax.top_k`` keeps the lower index), and
  each position's B = 10 tokens routed as a group of their own (the
  capacity min(B, max(8, ·)) = 8 binds) against the reference's forward
  one position at a time; the kept (expert, token) sets exactly, against
  the reference's routing restated in JAX (``lax.top_k``);
* mixtral's layout (two "L" layers at window 64, 4 experts, top-2,
  capacity factor 0.5 so the full-sequence forward drops): the prefill
  of a 96-token prompt and its cache against the reference's T decode
  steps, ``forward_hidden`` and its aux loss against
  ``transformer.forward_hidden``, 4 decode steps, and ``Model.grad_fn``
  against ``jax.value_and_grad`` of ``Model.loss`` (the router's gradient
  through the kept gates and the aux loss);
* llama4's layout (one whole period C, C, C, A at chunk 64, MoE on
  layers 1 and 3, 4 experts, top-1) past the chunk: the same at batch 1,
  and at batch 10 with a router that sends every token to one expert,
  so that each position's group of 10 drops 2 tokens, by tie order.

Tolerances (fp32 on the CPU): configs, routing, kept sets, ``pos`` tags
and greedy tokens exact; ``moe_forward`` and its aux loss 1e-5 relative
(one layer: the same matmuls summed in another order); hidden states,
logits, caches and gradients 1e-4 relative (norm of the difference over
the norm of the reference), the contract the port holds everywhere.

Each serving case compiles the reference's decode step once (its
prefill is T calls of it, as ``Model.prefill``'s ``lax.scan``) and its
forward once; the models are 2-4 layers at d_model 64.
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
from repro.models import moe as jmoe
from repro.models import transformer as jtfm
from repro.models.model import Model as JModel
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _torch_zoo import (RefDecoder, assert_trees, port_tokens, ref_kept,
                        rel, to_jax, tree_np, weights)
from repro_torch import convert
from repro_torch.configs import get_arch, reduced
from repro_torch.models import moe
from repro_torch.models import transformer as tfm
from repro_torch.models.model import Model
from repro_torch.tree import tree_leaves

MOE = ("mixtral-8x7b", "llama4-maverick-400b-a17b")
# ModelConfig.param_count() of the reference at the published widths
PARAM_COUNT = {"mixtral-8x7b": 46_571_716_608,
               "llama4-maverick-400b-a17b": 393_637_560_320}
T_PROMPT, MAX_LEN, STEPS = 96, 104, 4
GRAD_CHUNK = 32


def _cfgs(arch, layers, d_model=64, **over):
    """(reference config, port config) at reduced widths."""
    return (replace(jreduced(jget_arch(arch), d_model=d_model,
                             layers=layers), **over),
            replace(reduced(get_arch(arch), d_model=d_model, layers=layers),
                    **over))


def _mixtral():
    return _cfgs("mixtral-8x7b", 2, capacity_factor=0.5)


def _llama4():
    return _cfgs("llama4-maverick-400b-a17b", 4)


class _Spy:
    """Records every :func:`moe.route` of the forwards run under it."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = moe.route

        def spy(combine, cap):
            rt = real(combine, cap)
            self.calls.append((combine.detach().clone(), cap, rt))
            return rt
        monkeypatch.setattr(moe, "route", spy)

    def kept(self, i):
        _, _, rt = self.calls[i]
        return set(zip(rt.expert.tolist(), rt.token.tolist()))

    def drops(self, i):
        combine, _, rt = self.calls[i]
        return int((combine > 0).sum()) - len(rt.token)


# ---------------------------------------------------------------------------
# configs

@pytest.mark.parametrize("arch", MOE)
def test_moe_config_matches_reference(arch):
    """The full published config and its reduced variants, field by
    field, with every property and method."""
    j, t = jget_arch(arch), get_arch(arch)
    for jc, tc in ((j, t), (jreduced(j), reduced(t)),
                   (jreduced(j, d_model=64, layers=4),
                    reduced(t, d_model=64, layers=4))):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        for prop in ("resolved_head_dim", "is_encdec", "subquadratic",
                     "n_moe_layers"):
            assert getattr(tc, prop) == getattr(jc, prop), prop
        for meth in ("layer_types", "param_count", "active_param_count"):
            assert getattr(tc, meth)() == getattr(jc, meth)(), meth
        assert [tc.is_moe_layer(i) for i in range(tc.num_layers)] == \
            [jc.is_moe_layer(i) for i in range(jc.num_layers)]
    assert t.param_count() == PARAM_COUNT[arch]
    assert t.citation and t.citation == j.citation


@pytest.mark.parametrize("arch", MOE)
def test_moe_weights_held_are_the_analytic_count_and_final_norm(arch):
    """The port holds the reference's leaves (shapes read with
    ``jax.eval_shape``; the converter carries them both ways, the
    (E, ·, ·) expert stacks included), ``param_count()`` + d_model of
    them (the analytic count leaves out ``final_norm``); at the depths
    the card serves (mixtral 16 of 32 layers, llama4 one period of 4)
    that is 23,351,398,400 and 33,751,413,760."""
    jc, tc = _llama4() if arch != "mixtral-8x7b" else _mixtral()
    shapes = jax.eval_shape(JModel(jc).init, jax.random.PRNGKey(1))
    held = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    tp = Model(tc).init(1, device="cpu")
    assert tfm.param_count(tp) == held == tc.param_count() + tc.d_model
    want = jax.tree.map(lambda s: s.shape, shapes)
    tree = convert.model_params_to_numpy(tp, tc)
    assert jax.tree.map(np.shape, tree) == want
    back = convert.model_params_from_numpy(tree, tc, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(back), tree_leaves(tp)))
    layers = 16 if arch == "mixtral-8x7b" else 4
    cut = replace(get_arch(arch), num_layers=layers)
    assert cut.param_count() + cut.d_model == {
        "mixtral-8x7b": 23_351_398_400,
        "llama4-maverick-400b-a17b": 33_751_413_760}[arch]


def test_expert_stacks_use_the_reference_fan_in_and_target_dtype():
    """An (E, ·, ·) expert stack has the reference's std 1/sqrt(E) (its
    ``dense_init`` takes the leading axis as fan-in), truncated at 2σ,
    and is drawn straight into the target dtype."""
    cfg = replace(reduced(get_arch("llama4-maverick-400b-a17b"),
                          d_model=64), n_experts=16)
    gen = torch.Generator().manual_seed(0)
    p = moe.init_moe(gen, cfg, torch.bfloat16)
    assert p["w_up"].dtype == torch.bfloat16
    assert p["w_up"].shape == (16, 64, 192)
    w = p["w_up"].float()
    sigma = 1.0 / np.sqrt(16)
    assert float(w.abs().max()) <= 2.0 * sigma * (1 + 2 ** -7)
    assert abs(float(w.std()) / sigma - 0.88) < 0.02
    assert not torch.equal(p["w_up"][0], p["w_up"][1])


# ---------------------------------------------------------------------------
# moe_forward

@pytest.mark.parametrize("case", ["top2_drops", "top1_ties", "group_b10"])
def test_moe_forward_matches_reference(case, monkeypatch):
    """``moe_forward`` and its aux loss against the reference's, and the
    kept (expert, token) sets equal, in three cases that drop tokens."""
    arch = "mixtral-8x7b" if case == "top2_drops" \
        else "llama4-maverick-400b-a17b"
    over = {} if case == "group_b10" else dict(capacity_factor=0.5)
    jcfg, cfg = _cfgs(arch, 2, d_model=32, **over)
    shape = (10, 6, 32) if case == "group_b10" else (2, 48, 32)
    tp = moe.init_moe(torch.Generator().manual_seed(1), cfg)
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    if case == "group_b10":
        # a direction every token shares, which the router's expert 0
        # follows: each position's 10 tokens all choose expert 0, which
        # keeps 8 of them
        u = rng.standard_normal(shape[-1]).astype(np.float32)
        x = 0.1 * x + u
        tp["router"][:, 0] = torch.tensor(u)
    jp = {k: jnp.asarray(v.numpy()) for k, v in tp.items()}
    spy = _Spy(monkeypatch)
    group = shape[0] if case == "group_b10" else None
    out, aux = moe.moe_forward(tp, torch.tensor(x), cfg, group=group)
    if group is None:
        j_out, j_aux = jax.jit(lambda p, a: jmoe.moe_forward(p, a, jcfg))(
            jp, jnp.asarray(x))
        kept, routed = ref_kept(jp, jnp.asarray(x), jcfg)
        assert abs(float(aux) - float(j_aux)) <= 1e-5 * float(j_aux)
    else:
        # the reference routes a position's B tokens in its decode step:
        # its forward of one position at a time; token (b, t) is t*B + b
        # in the port's grouped order
        step = jax.jit(lambda p, a: jmoe.moe_forward(p, a, jcfg))
        j_out = np.concatenate([np.asarray(step(jp, jnp.asarray(
            x[:, t:t + 1]))[0]) for t in range(shape[1])], axis=1)
        kept, routed = set(), 0
        for t in range(shape[1]):
            k_t, r_t = ref_kept(jp, jnp.asarray(x[:, t:t + 1]), jcfg)
            kept |= {(e, t * shape[0] + b) for e, b in k_t}
            routed += r_t
    assert rel(out.numpy(), j_out) <= 1e-5
    assert len(spy.calls) == 1
    assert spy.kept(0) == kept
    assert spy.drops(0) == routed - len(kept) > 0
    if case != "top2_drops":
        assert np.all(spy.calls[0][2].gate.numpy() == 1.0)   # exact ties
    if case == "group_b10":     # batch rows 8 and 9 lose the tie
        assert spy.kept(0) == {(0, t * 10 + b) for t in range(shape[1])
                               for b in range(8)}


def test_moe_forward_refuses_another_grouping():
    cfg = reduced(get_arch("mixtral-8x7b"), d_model=32)
    tp = moe.init_moe(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="group=3"):
        moe.moe_forward(tp, torch.zeros(2, 3, 32), cfg, group=3)


# ---------------------------------------------------------------------------
# serving and training, mixtral's and llama4's layouts

def _prompt(seed, b, vocab):
    return np.random.default_rng(seed).integers(
        0, vocab, (b, T_PROMPT)).astype(np.int32)


def _serving(jcfg, cfg, tp, jp, prompt, monkeypatch, forward=True):
    """The prefill and its cache, ``forward_hidden`` with its aux loss
    (``forward``), and STEPS greedy decode steps, against the reference.
    Returns the port's routing spy."""
    ref = RefDecoder(jcfg, jp)
    ttok = port_tokens(prompt)
    spy = _Spy(monkeypatch)
    lg_j, c_j = ref.prefill(prompt, MAX_LEN)
    lg_t, c_t = Model(cfg).prefill(tp, {"tokens": ttok}, MAX_LEN)
    assert rel(lg_t.numpy(), lg_j) <= 1e-4
    assert_trees(convert.model_cache_to_numpy(c_t, cfg), tree_np(c_j), 1e-4)
    if forward:
        h_t, aux_t, off = tfm.forward_hidden(tp, cfg, {"tokens": ttok})
        h_j, aux_j = jax.jit(lambda p, t: jtfm.forward_hidden(
            p, jcfg, {"tokens": t})[:2])(jp, jnp.asarray(prompt))
        assert off == 0
        assert rel(h_t.numpy(), h_j) <= 1e-4
        assert abs(float(aux_t) - float(aux_j)) <= 1e-5 * float(aux_j)
    tok_j, tok_t = jnp.asarray(prompt[:, -1]), ttok[:, -1]
    for i in range(STEPS):
        l_j, c_j = ref.decode(c_j, tok_j, T_PROMPT + i)
        l_t, c_t = tfm.decode_step(tp, cfg, c_t, tok_t, T_PROMPT + i)
        assert rel(l_t.numpy(), l_j) <= 1e-4, i
        tok_j, tok_t = jnp.argmax(l_j, -1), torch.argmax(l_t, -1)
        assert np.array_equal(tok_t.numpy(), np.asarray(tok_j)), i
    assert_trees(convert.model_cache_to_numpy(c_t, cfg), tree_np(c_j), 1e-4)
    return spy


def test_mixtral_layout_serving_matches_reference(monkeypatch):
    """Batch 2: per position the capacity (2) never binds; the
    full-sequence forward (192 tokens, capacity 48 for a load of ~96 an
    expert) drops."""
    jcfg, cfg = _mixtral()
    tp, jp = weights(cfg, 0)
    spy = _serving(jcfg, cfg, tp, jp, _prompt(0, 2, cfg.vocab_size),
                   monkeypatch)
    # prefill: one route a MoE layer; forward_hidden: one more each
    assert spy.drops(0) == spy.drops(1) == 0
    assert spy.drops(2) > 0 and spy.drops(3) > 0


def _route_all_to_expert_0(tp, cfg, prompt, monkeypatch):
    """Weights under which every token of ``prompt`` prefers expert 0 in
    every MoE layer: a direction shared by all embedding rows, and each
    router's expert 0 set, layer by layer, to the mean direction of the
    inputs the port's prefill gives it (the expert outputs of the layer
    before are nearly equal for all tokens, so a shared direction rules
    the residual stream)."""
    u = torch.tensor(np.random.default_rng(2).standard_normal(
        cfg.d_model).astype(np.float32))
    tp["embed"] += u / u.norm()
    real = moe.moe_forward
    for i in range(cfg.num_layers):
        if not cfg.is_moe_layer(i):
            continue
        seen = []

        def capture(p, x, c, group=None):
            seen.append(x)
            return real(p, x, c, group)
        monkeypatch.setattr(moe, "moe_forward", capture)
        tfm.prefill_hidden(tp, cfg, port_tokens(prompt), MAX_LEN)
        m = seen[len([j for j in range(i) if cfg.is_moe_layer(j)])]
        m = m.mean((0, 1))
        tp["layers"][i]["ffn"]["router"][:, 0] = 8.0 * m / m.norm()
    monkeypatch.setattr(moe, "moe_forward", real)


@pytest.mark.parametrize("batch", [1, 10])
def test_llama4_layout_serving_matches_reference(batch, monkeypatch):
    """One period (C, C, C, A; MoE on 1 and 3) past the 64-token chunk.
    At batch 10 every token prefers expert 0
    (:func:`_route_all_to_expert_0`), so each position keeps batch rows
    0-7 and drops rows 8 and 9: ties decided as ``lax.top_k``."""
    jcfg, cfg = _llama4()
    assert cfg.layer_types() == ("C", "C", "C", "A") and cfg.chunk == 64
    tp, _ = weights(cfg, 0)
    prompt = _prompt(1, batch, cfg.vocab_size)
    if batch == 10:
        _route_all_to_expert_0(tp, cfg, prompt, monkeypatch)
    jp = to_jax(tp, cfg)
    spy = _serving(jcfg, cfg, tp, jp, prompt, monkeypatch,
                   forward=batch == 1)
    if batch == 10:
        for i in (0, 1):            # the prefill's two MoE layers
            assert spy.drops(i) == 2 * T_PROMPT
            assert spy.kept(i) == {(0, t * 10 + b) for t in range(T_PROMPT)
                                   for b in range(8)}
    else:
        assert spy.drops(0) == spy.drops(1) == 0


def test_moe_grads_match_reference():
    """``Model.grad_fn`` against ``jax.value_and_grad`` of the reference
    loss on the same weights and batch (2 x 72 tokens, chunk 32), at
    mixtral's layout: the loss, its aux metric and every gradient leaf.
    Its forward drops (capacity factor 0.5), so the router's gradient
    runs through the kept gates and the aux loss. Then the same with
    every layer rematerialized: equal."""
    jcfg, cfg = _mixtral()
    tp, jp = weights(cfg, 3)
    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (2, 72)).astype(np.int32)
    (l_j, m_j), g_j = jax.jit(JModel(jcfg).grad_fn(GRAD_CHUNK))(
        jp, {"tokens": jnp.asarray(tokens)})
    (l_t, m_t), g_t = Model(cfg).grad_fn(GRAD_CHUNK)(
        tp, {"tokens": port_tokens(tokens)})
    assert abs(float(l_t) - float(l_j)) <= 1e-5 * abs(float(l_j))
    assert float(m_j["aux_loss"]) > 0
    assert abs(float(m_t["aux_loss"]) - float(m_j["aux_loss"])) \
        <= 1e-5 * float(m_j["aux_loss"])
    worst = assert_trees(convert.model_params_to_numpy(g_t, cfg),
                         tree_np(g_j), 1e-4)
    print(f"mixtral layout: loss {float(l_t):.6f} vs {float(l_j):.6f}, aux "
          f"{float(m_t['aux_loss']):.6e}, worst grad leaf {worst:.2e}")
    for i in range(cfg.num_layers):
        if cfg.is_moe_layer(i):
            assert float(g_t["layers"][i]["ffn"]["router"].abs().max()) > 0
    # every layer rematerialized (the routing and the chunks run again in
    # the backward): the same loss and gradients, bit for bit
    (l_r, _), g_r = Model(replace(cfg, remat=True)).grad_fn(GRAD_CHUNK)(
        tp, {"tokens": port_tokens(tokens)})
    assert float(l_r) == float(l_t)
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(g_r), tree_leaves(g_t)))
