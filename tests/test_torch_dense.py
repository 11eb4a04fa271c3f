"""The port's four dense architectures (``gemma2-2b``, ``granite-3-8b``,
``h2o-danube-3-4b``, ``mistral-large-123b``) against the JAX reference:
their configs field by field, and their serving path at reduced widths on
identical inputs (weights from the port's seeded init, carried to the
reference with ``repro_torch.convert``; prompts from numpy with a
seed).

Their blocks are only "A" (global) and "L" (sliding-window) attention
with RoPE and dense GeGLU/SwiGLU FFNs, which the port already runs for
``recurrentgemma-2b``; what is new is held here by the cases:

* ``gemma2-2b``: the ("L", "A") pattern (3 layers: one stacked cycle and
  a tail layer), GeGLU, ``emb_scale``, and both softcaps, at 1
  (attention) and 2 (final logits) so that tanh bites on random weights
  (at the published 50 and 30 the caps move scores of order 1 by ~1e-4,
  inside the tolerance; the published values are held by the config
  test and by ``tests/test_torch_train.py``'s gemma2 gradients);
* ``h2o-danube-3-4b``: all "L" at window 64 (the 96-token prompt wraps
  the ring), SwiGLU, and its published ``head_dim`` 120, not a multiple
  of 64 (``reduced`` resets it to d_model // n_heads);
* ``granite-3-8b``: all "A", SwiGLU, vocab not a power of two at full
  width;
* ``mistral-large-123b``: all "A" with its published ``rope_theta`` 1e6
  (``reduced`` resets it to 1e4).

Tolerances (fp32 on the CPU): configs, cache ``pos`` tags and greedy
tokens exact; hidden states, prefill logits, every cache leaf and the
decode logits within 1e-4 relative (norm of the difference over the
norm of the reference), the contract the port holds everywhere (matmuls
and softmaxes sum in another order).

Each case compiles its reference programs (the decode-step prefill and
one jitted decode step) inside one test, so that the workers of a
parallel run never compile them twice; the port's ``forward_hidden``
is held to the reference through its last position's logits (the
reference's prefill logits) and to the port's own prefill at every
position, which spares a compile of the reference's forward. The
weights-held test reads the reference's shapes with ``jax.eval_shape``.
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
from repro.models import transformer as jtfm
from repro.models.model import Model as JModel
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _torch_zoo import assert_trees as _assert_trees
from _torch_zoo import rel as _rel
from _torch_zoo import tree_np as _tree_np
from _torch_zoo import weights as _weights
from repro_torch import convert
from repro_torch.configs import get_arch, reduced
from repro_torch.models import transformer as tfm
from repro_torch.models.common import softcap
from repro_torch.models.model import Model
from repro_torch.serve.decode import greedy_generate

DENSE = ("gemma2-2b", "granite-3-8b", "h2o-danube-3-4b",
         "mistral-large-123b")
# ModelConfig.param_count() of the reference, the published widths
PARAM_COUNT = {"gemma2-2b": 2_614_219_776,
               "h2o-danube-3-4b": 3_838_955_520,
               "granite-3-8b": 8_170_844_160,
               "mistral-large-123b": 122_207_404_032}
T_PROMPT, MAX_LEN, STEPS = 96, 104, 4
# per arch, on top of reduced(): what reduced() resets (head_dim,
# rope_theta) and caps tight enough to bite on random weights
OVERRIDES = {"gemma2-2b": dict(attn_softcap=1.0, logit_softcap=2.0),
             "h2o-danube-3-4b": dict(head_dim=120),
             "mistral-large-123b": dict(rope_theta=1e6)}


def _case(name: str):
    """(reference config, port config) of a serving case."""
    layers = 3 if name == "gemma2-2b" else 2
    over = OVERRIDES.get(name, {})
    return (replace(jreduced(jget_arch(name), d_model=64, layers=layers),
                    **over),
            replace(reduced(get_arch(name), d_model=64, layers=layers),
                    **over))


# ---------------------------------------------------------------------------
# configs

@pytest.mark.parametrize("arch", DENSE)
def test_dense_config_matches_reference(arch):
    """The full published config and its reduced variant, field by field,
    with every property and method."""
    j, t = jget_arch(arch), get_arch(arch)
    for jc, tc in ((j, t), (jreduced(j), reduced(t)),
                   (jreduced(j, d_model=64, layers=3),
                    reduced(t, d_model=64, layers=3))):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        for prop in ("resolved_head_dim", "is_encdec", "subquadratic",
                     "n_moe_layers"):
            assert getattr(tc, prop) == getattr(jc, prop), prop
        for meth in ("layer_types", "param_count", "active_param_count"):
            assert getattr(tc, meth)() == getattr(jc, meth)(), meth
    assert t.param_count() == PARAM_COUNT[arch]
    assert t.citation and t.citation == j.citation


@pytest.mark.parametrize("arch", DENSE)
def test_dense_weights_held_are_the_analytic_count_and_final_norm(arch):
    """The weights the port holds (``transformer.param_count``) equal the
    reference's held leaves, and ``param_count()`` + d_model: the
    analytic count leaves out ``final_norm`` (d_model weights), as it
    does for recurrentgemma-2b. At full width, then, gemma2-2b holds
    2,614,222,080, h2o-danube-3-4b 3,838,959,360, granite-3-8b
    8,170,848,256."""
    jc, tc = _case(arch)
    shapes = jax.eval_shape(JModel(jc).init, jax.random.PRNGKey(1))
    held = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert tfm.param_count(Model(tc).init(1, device="cpu")) == held
    assert held == tc.param_count() + tc.d_model
    full = get_arch(arch)
    assert full.param_count() + full.d_model == {
        "gemma2-2b": 2_614_222_080, "h2o-danube-3-4b": 3_838_959_360,
        "granite-3-8b": 8_170_848_256,
        "mistral-large-123b": 122_207_416_320}[arch]


def test_ported_archs_resolve_and_the_others_raise():
    """Every arch the reference registers resolves (the last two came
    with the encoder-decoder and VLM paths); any other name raises."""
    for arch in DENSE + ("recurrentgemma-2b", "mixtral-8x7b",
                         "llama4-maverick-400b-a17b", "rwkv6-1.6b",
                         "whisper-small", "paligemma-3b"):
        assert get_arch(arch).name == arch
    with pytest.raises(KeyError, match="unknown arch 'whisper-large'"):
        get_arch("whisper-large")


# ---------------------------------------------------------------------------
# serving

@pytest.mark.parametrize("arch", DENSE)
def test_dense_serving_matches_reference(arch):
    """``Model.prefill`` (one full-sequence forward, against the
    reference's T decode steps) with its cache, ``forward_hidden``, 4
    decode steps and ``greedy_generate``'s tokens (the reference's greedy
    loop's), on a 96-token prompt (longer than the window 64) at batch
    2."""
    jcfg, cfg = _case(arch)
    tp, jp = _weights(cfg, 0)
    prompt = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, T_PROMPT)).astype(np.int32)
    jtok, ttok = jnp.asarray(prompt), torch.tensor(prompt).long()

    # the prefill and its cache
    lg_j, c_j = JModel(jcfg).prefill(jp, {"tokens": jtok}, MAX_LEN)
    lg_t, c_t = Model(cfg).prefill(tp, {"tokens": ttok}, MAX_LEN)
    assert _rel(lg_t.numpy(), lg_j) <= 1e-4
    _assert_trees(convert.model_cache_to_numpy(c_t, cfg), _tree_np(c_j),
                  1e-4)
    # forward_hidden (the training forward, blocks.layer_forward): its
    # last position's logits against the reference's prefill logits,
    # every position against the port's prefill (blocks.layer_prefill)
    h_t, aux, off = tfm.forward_hidden(tp, cfg, {"tokens": ttok})
    assert off == 0 and float(aux) == 0.0
    lg_f = softcap(tfm.logits_fn(tp, cfg, h_t[:, -1]), cfg.logit_softcap)
    assert _rel(lg_f.numpy(), lg_j) <= 1e-4
    h_p, _ = tfm.prefill_hidden(tp, cfg, ttok, MAX_LEN)
    assert _rel(h_t.numpy(), h_p.numpy()) <= 1e-5

    # greedy decoding from the cache in the loop of the reference's
    # greedy_generate (the prompt's last token again at position T, then
    # each step's argmax), its decode step jitted as there
    step = jax.jit(lambda p, c, t, i: jtfm.decode_step(p, jcfg, c, t, i))
    tok_j, tok_t = jtok[:, -1], ttok[:, -1]
    greedy = []
    for i in range(STEPS):
        l_j, c_j = step(jp, c_j, tok_j, jnp.asarray(T_PROMPT + i))
        l_t, c_t = tfm.decode_step(tp, cfg, c_t, tok_t, T_PROMPT + i)
        assert _rel(l_t.numpy(), l_j) <= 1e-4, i
        tok_j, tok_t = jnp.argmax(l_j, -1), torch.argmax(l_t, -1)
        assert np.array_equal(tok_t.numpy(), np.asarray(tok_j)), i
        greedy.append(np.asarray(tok_j))
    _assert_trees(convert.model_cache_to_numpy(c_t, cfg), _tree_np(c_j),
                  1e-4)
    got = greedy_generate(Model(cfg), tp, ttok, STEPS, MAX_LEN)
    assert got.shape == (2, T_PROMPT + STEPS)
    assert np.array_equal(got[:, :T_PROMPT].numpy(), prompt)
    assert np.array_equal(got[:, T_PROMPT:].numpy(), np.stack(greedy, 1))
