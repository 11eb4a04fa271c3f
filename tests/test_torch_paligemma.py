"""The port's VLM family (``paligemma-3b``) and the stub frontends
(``models/frontends.py``) against the JAX reference on identical inputs:
the config field by field and its weights held, ``_band_mask`` with a
bidirectional prefix, ``attn_forward`` with ``prefix_len``,
``forward_hidden``, the loss and ``Model.grad_fn`` with patches,
``serve.make_prefill_step`` (the one serve path where the image prefix
runs), ``Model.prefill`` (which ignores the patches, as the reference's
does), the launcher's arithmetic (``prompt_len - vis_tokens`` text
tokens, the first decode step at ``prompt_len``), ``batch_spec`` and
``make_batch``; at reduced widths (d_model 64, 4 query heads of 16 over
one kv head, 2 layers, 8 patches, ``emb_scale`` kept; weights from the
port's seeded init carried to the reference with ``repro_torch.convert``).

Tolerances (fp32 on the CPU): configs, masks, shapes, dtypes, tokens and
offsets exact; one attention layer 1e-5 relative (matmul order); the
model's hidden states, logits, loss and gradients 1e-4 relative (norm of
the difference over the norm of the reference), the contract the port
holds everywhere.
"""
import dataclasses
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import attention as jattn
from repro.models import frontends as jfrontends
from repro.models import transformer as jtfm
from repro.models.model import Model as JModel
from repro.serve.decode import make_prefill_step as jmake_prefill_step
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _torch_zoo import (RefDecoder, assert_trees, port_tokens, rel, tree_np,
                        weights)
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs import get_arch, reduced
from repro_torch.launch import serve as serve_mod
from repro_torch.models import attention, frontends
from repro_torch.models import transformer as tfm
from repro_torch.models.model import Model
from repro_torch.serve.decode import make_prefill_step

ARCH = "paligemma-3b"
B, SEQ, GRAD_CHUNK = 2, 32, 12       # 8 patches + 24 text tokens


def _cfgs():
    return (jreduced(jget_arch(ARCH), d_model=64),
            reduced(get_arch(ARCH), d_model=64))


JCFG, CFG = _cfgs()


@pytest.fixture(scope="module")
def zoo():
    """The port's seed-0 weights and their reference copy, a batch of B
    rows of 8 patches and SEQ - 8 text tokens, and the reference's
    decoder (its decode step compiled once for the module)."""
    tp, jp = weights(CFG, 0)
    batch = Model(CFG).dummy_batch(0, B, SEQ)
    return dict(tp=tp, jp=jp, batch=batch, ref=RefDecoder(JCFG, jp),
                jbatch={k: jnp.asarray(v.numpy()) for k, v in batch.items()})


# ---------------------------------------------------------------------------
# config

def test_paligemma_config_matches_reference():
    """The full published config and its reduced variant, field by
    field, with every property and method."""
    j, t = jget_arch(ARCH), get_arch(ARCH)
    for jc, tc in ((j, t), (jreduced(j), reduced(t)), _cfgs()):
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        for prop in ("resolved_head_dim", "is_encdec", "subquadratic",
                     "n_moe_layers"):
            assert getattr(tc, prop) == getattr(jc, prop), prop
        for meth in ("layer_types", "param_count", "active_param_count"):
            assert getattr(tc, meth)() == getattr(jc, meth)(), meth
    assert t.vis_tokens == 256 and t.emb_scale and CFG.emb_scale
    assert CFG.vis_tokens == 8 and CFG.n_kv_heads == 1
    assert t.param_count() == 2_508_660_736
    assert t.citation and t.citation == j.citation


def test_paligemma_weights_held():
    """The port holds the reference's leaves, shape for shape; at full
    width 2,508,662,784 = ``param_count()`` + d_model (the analytic
    count leaves out ``final_norm``)."""
    shapes = jax.eval_shape(JModel(JCFG).init, jax.random.PRNGKey(1))
    tp = Model(CFG).init(1, device="cpu")
    got = jax.tree.map(np.shape, convert.model_params_to_numpy(tp, CFG))
    assert got == jax.tree.map(lambda s: s.shape, shapes)
    held = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert tfm.param_count(tp) == held == CFG.param_count() + CFG.d_model
    full = jax.eval_shape(JModel(jget_arch(ARCH)).init, jax.random.PRNGKey(1))
    n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(full))
    assert n == 2_508_662_784 == get_arch(ARCH).param_count() + 2048


# ---------------------------------------------------------------------------
# the prefix mask and attention

@pytest.mark.parametrize("layer_type", ["A", "L", "C"])
def test_band_mask_with_prefix_matches_reference(layer_type):
    """``_band_mask`` exactly equal for prefixes 0, 1, 5 and 12 over
    query positions with padding (-1) and a shifted key range; the final
    ``qp >= 0`` of the full-sequence path removes the padded queries the
    prefix term lets through."""
    cfg = replace(CFG, window=4, chunk=6)
    jcfg = replace(JCFG, window=4, chunk=6)
    qpos = np.concatenate([np.arange(14), [-1, -1]]).astype(np.int32)
    for kpos in (np.arange(14, dtype=np.int32),
                 np.arange(3, 17, dtype=np.int32)):
        for p in (0, 1, 5, 12):
            want = np.asarray(jattn._band_mask(
                jnp.asarray(qpos), jnp.asarray(kpos), layer_type, jcfg, p))
            got = attention._band_mask(torch.tensor(qpos), torch.tensor(kpos),
                                       layer_type, cfg, p).numpy()
            assert np.array_equal(got, want), (layer_type, p)
            if kpos[0] < p:           # the pads fall in the prefix term
                assert got[-1].any()
                assert not (got & (qpos[:, None] >= 0))[-1].any()


@pytest.mark.parametrize("layer_type", ["A", "L"])
def test_attn_forward_with_prefix_matches_reference(layer_type):
    """``attn_forward`` over T = 21 in query chunks of 8 (the last one
    padded) with a prefix of 8, against the reference's; "L" at window
    6 also slices the keys to the band. The prefix sees its own later
    positions, the text does not."""
    cfg = replace(CFG, window=6)
    jcfg = replace(JCFG, window=6)
    gen = torch.Generator().manual_seed(5)
    tp = attention.init_attn(gen, cfg)
    jp = {k: jnp.asarray(v.numpy()) for k, v in tp.items()}
    x = np.random.default_rng(5).standard_normal(
        (B, 21, cfg.d_model)).astype(np.float32)
    fwd = jax.jit(lambda p, a: jattn.attn_forward(
        p, a, cfg=jcfg, layer_type=layer_type, prefix_len=8, q_chunk=8))
    want = fwd(jp, jnp.asarray(x))
    got = attention.attn_forward(tp, torch.tensor(x), cfg=cfg,
                                 layer_type=layer_type, prefix_len=8,
                                 q_chunk=8)
    assert rel(got.numpy(), want) <= 1e-5
    x2 = x.copy()
    x2[:, 7] += 1.0                   # the prefix's last position
    got2 = attention.attn_forward(tp, torch.tensor(x2), cfg=cfg,
                                  layer_type=layer_type, prefix_len=8,
                                  q_chunk=8)
    assert not torch.allclose(got2[:, 0], got[:, 0])
    x3 = x.copy()
    x3[:, 20] += 1.0                  # the last text position
    got3 = attention.attn_forward(tp, torch.tensor(x3), cfg=cfg,
                                  layer_type=layer_type, prefix_len=8,
                                  q_chunk=8)
    assert torch.equal(got3[:, :20], got[:, :20])


# ---------------------------------------------------------------------------
# the model

def test_paligemma_forward_and_prefill_step_match_reference(zoo):
    """``forward_hidden`` with patches (offset 8, the patches unscaled
    after the scaled embeddings) and ``serve.make_prefill_step`` against
    the reference's ``make_prefill_step(model, None, batch=B)``; then
    ``Model.prefill``, which ignores the patches as the reference's
    does: equal to its text-only prefill and to the reference's
    decode-step prefill of the text."""
    tp, jp, batch, jb, ref = (zoo["tp"], zoo["jp"], zoo["batch"],
                              zoo["jbatch"], zoo["ref"])
    jstep = jmake_prefill_step(JModel(JCFG), None, batch=B)
    h_j, aux_j, off_j, lg_j = jax.jit(lambda p, b: jtfm.forward_hidden(
        p, JCFG, b) + (jstep(p, b),))(jp, jb)
    h_t, aux_t, off_t = tfm.forward_hidden(tp, CFG, batch)
    assert off_t == int(off_j) == 8 and float(aux_t) == 0.0
    assert h_t.shape == (B, SEQ, CFG.d_model)
    assert rel(h_t.numpy(), h_j) <= 1e-4
    lg_t = make_prefill_step(Model(CFG))(tp, batch)
    assert rel(lg_t.numpy(), lg_j) <= 1e-4
    # the patches attend both ways: the last patch moves the first one
    other = dict(batch, patches=batch["patches"].clone())
    other["patches"][:, -1] += 1.0
    h_o = tfm.forward_hidden(tp, CFG, other)[0]
    assert not torch.allclose(h_o[:, 0], h_t[:, 0])

    text = batch["tokens"]
    lg_p, c_p = Model(CFG).prefill(tp, batch, SEQ + 4)
    lg_n, c_n = Model(CFG).prefill(tp, {"tokens": text}, SEQ + 4)
    assert torch.equal(lg_p, lg_n)
    lg_r, c_r = ref.prefill(text.numpy().astype(np.int32), SEQ + 4)
    assert rel(lg_p.numpy(), lg_r) <= 1e-4
    assert_trees(convert.model_cache_to_numpy(c_p, CFG), tree_np(c_r), 1e-4)


def test_paligemma_grads_match_reference(zoo):
    """``Model.loss`` and ``Model.grad_fn`` with patches against
    ``jax.value_and_grad`` of the reference loss (the prefix's 8
    positions carry no loss): the loss and every gradient leaf."""
    tp, jp, batch, jb = zoo["tp"], zoo["jp"], zoo["batch"], zoo["jbatch"]
    (l_j, _), g_j = jax.jit(JModel(JCFG).grad_fn(GRAD_CHUNK))(jp, jb)
    (l_t, _), g_t = Model(CFG).grad_fn(GRAD_CHUNK)(tp, batch)
    assert abs(float(l_t) - float(l_j)) <= 1e-5 * abs(float(l_j))
    loss, _ = Model(CFG).loss(tp, batch, GRAD_CHUNK)
    assert float(loss) == float(l_t)
    worst = assert_trees(convert.model_params_to_numpy(g_t, CFG),
                         tree_np(g_j), 1e-4)
    print(f"paligemma: loss {float(l_t):.6f} vs {float(l_j):.6f}, worst "
          f"grad leaf {worst:.2e}")


def test_paligemma_launcher_is_the_reference_loop(monkeypatch, zoo):
    """Passed-in prompts of ``prompt_len - vis_tokens`` text tokens, one
    slot: each request's tokens equal the reference launcher's loop
    (prefill of the text, then greedy decode steps from index
    ``prompt_len``), run by the reference on the port's seed-0
    weights."""
    prompt_len, gen = 24, 4
    text = prompt_len - CFG.vis_tokens
    monkeypatch.setattr(serve_mod, "build_model",
                        lambda arch, smoke=False: Model(CFG))
    rng = np.random.default_rng(7)
    prompts = rng.integers(0, CFG.vocab_size, (2, text)).astype(np.int32)
    res = serve_mod.serve(ARCH, batch=1, requests=2, prompt_len=prompt_len,
                          gen=gen, device="cpu",
                          prompts=[port_tokens(p) for p in prompts])
    assert [r.rid for r in res.requests] == [0, 1]
    assert res.n_params == tfm.param_count(zoo["tp"])
    ref = zoo["ref"]
    for r in res.requests:
        logits, cache = ref.prefill(prompts[r.rid:r.rid + 1],
                                    prompt_len + gen)
        tok, want = int(jnp.argmax(logits[0])), []
        for i in range(gen):
            logits, cache = ref.decode(cache, jnp.asarray([tok]),
                                       prompt_len + i)
            tok = int(jnp.argmax(logits[0]))
            want.append(tok)
        assert r.generated == want


# ---------------------------------------------------------------------------
# the frontends

def test_batch_spec_matches_reference():
    """``frontends.batch_spec``'s meta tensors against the reference's
    ``ShapeDtypeStruct``s: shapes and dtypes for the VLM, the
    encoder-decoder and a decoder-only arch, at two shapes."""
    to_jnp = {torch.int32: jnp.int32, torch.float32: jnp.float32,
              torch.bfloat16: jnp.bfloat16}
    for arch in (ARCH, "whisper-small", "gemma2-2b"):
        for shape in ("train_4k", "decode_32k"):
            for jdt, tdt in ((jnp.bfloat16, torch.bfloat16),
                             (jnp.float32, torch.float32)):
                want = jfrontends.batch_spec(jget_arch(arch),
                                             jbase.SHAPES[shape], jdt)
                got = frontends.batch_spec(get_arch(arch),
                                           tbase.SHAPES[shape], tdt)
                assert sorted(got) == sorted(want)
                for k, w in want.items():
                    assert got[k].device.type == "meta"
                    assert tuple(got[k].shape) == w.shape, (arch, k)
                    assert to_jnp[got[k].dtype] == w.dtype, (arch, k)
    assert tbase.SHAPES == {k: tbase.ShapeConfig(**dataclasses.asdict(v))
                            for k, v in jbase.SHAPES.items()}


def test_make_batch_layout_and_decoder_only_stream():
    """``make_batch``: ``seq - vis_tokens`` text tokens, labels the
    tokens shifted left with 0 last, mask 1 with the last position 0,
    0.02·N(0, 1) patches / frames in the asked dtype; a decoder-only
    model's tokens are the stream ``Model.dummy_batch`` drew before the
    frontends (one ``randint`` from a CPU generator seeded with the
    seed), and ``Model.dummy_batch`` is ``make_batch``."""
    b = frontends.make_batch(3, CFG, 4, SEQ, torch.bfloat16)
    assert sorted(b) == ["labels", "mask", "patches", "tokens"]
    text = SEQ - CFG.vis_tokens
    assert b["tokens"].shape == b["labels"].shape == (4, text)
    assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert not b["labels"][:, -1].any()
    assert b["mask"].dtype == torch.float32
    assert b["mask"][:, :-1].all() and not b["mask"][:, -1].any()
    assert b["patches"].shape == (4, 8, 64)
    assert b["patches"].dtype == torch.bfloat16
    assert abs(float(b["patches"].float().std()) - 0.02) < 2e-3
    wcfg = reduced(get_arch("whisper-small"), d_model=64)
    w = Model(wcfg).dummy_batch(3, 2, 10)
    assert w["frames"].shape == (2, 16, 64) and w["tokens"].shape == (2, 10)
    assert w["frames"].dtype == torch.float32

    dcfg = reduced(get_arch("gemma2-2b"), d_model=64)
    d = Model(dcfg).dummy_batch(3, 2, 10)
    assert sorted(d) == ["labels", "mask", "tokens"]
    want = torch.randint(0, dcfg.vocab_size, (2, 10),
                         generator=torch.Generator().manual_seed(3))
    assert torch.equal(d["tokens"], want)
    for k, v in frontends.make_batch(3, dcfg, 2, 10).items():
        assert torch.equal(v, d[k])
