"""The port's one-token attention over caches longer than
``_DECODE_CHUNK`` slots (``models.attention._decode_attn``'s chunked
branch) against the reference's (``repro/models/attention.py:207-256``),
with the chunk patched to 16 slots in both packages, so that small caches
take the branch:

* ``_decode_attn`` on caches of several chunks, a ragged last chunk,
  stale non-zero keys and values in invalid slots, and a wholly invalid
  chunk before the first valid one, softcap 50 and 0, fp32 and bf16;
  against the port's own whole-cache ``_sdpa`` too (fp32), and with no
  padded copy of the cache;
* ``attn_decode`` on "A", "L" and "C" caches that hold a prompt's
  positions (the ring wrapped, stale positions outside the band);
* four greedy ``decode_step``s after a 70-token prefill of reduced
  gemma2-2b ("L", "A", both softcaps) and llama4 ("C", "C", "C", "A")
  against the reference's decode step, jitted with the patched chunk.

Tolerances: 1e-5 relative (norm of the difference over the norm of the
reference) in fp32 for one attention, 5e-2 in bf16; logits 1e-4
relative and tokens exactly for whole models, the contract the port
holds everywhere.
"""
from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models import attention as jattn
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from _torch_zoo import RefDecoder, port_tokens, rel, weights
from repro_torch.configs import get_arch, reduced
from repro_torch.models import attention
from repro_torch.models.model import Model

CHUNK = 16
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
B, KV, G, HD = 2, 2, 2, 8


@pytest.fixture(autouse=True)
def chunk16(monkeypatch):
    """Both packages scan caches of more than 16 slots in chunks."""
    monkeypatch.setattr(jattn, "_DECODE_CHUNK", CHUNK)
    monkeypatch.setattr(attention, "_DECODE_CHUNK", CHUNK)


def _valid(case: str, s: int, rng) -> np.ndarray:
    if case == "invalid_chunk_first":      # slots 0..31 never valid
        return np.arange(s) >= 2 * CHUNK
    if case == "stale":                    # about half the slots stale
        v = rng.random(s) < 0.5
        v[-1] = True
        return v
    return np.arange(s) < s - 3            # the last three slots empty


# (name, cache slots): 4 whole chunks, a ragged last chunk of 5, stale
# values in ~half the slots, two invalid chunks then a ragged valid one
CASES = [("several_chunks", 64), ("ragged", 53), ("stale", 70),
         ("invalid_chunk_first", 45)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cap", [50.0, 0.0])
@pytest.mark.parametrize("case,s", CASES)
def test_decode_attn_matches_reference(case, s, cap, dtype, monkeypatch):
    rng = np.random.default_rng(len(case) * 100 + s)
    q = rng.standard_normal((B, 1, KV, G, HD)).astype(np.float32) * 3
    k = rng.standard_normal((B, s, KV, HD)).astype(np.float32) * 3
    v = rng.standard_normal((B, s, KV, HD)).astype(np.float32)
    valid = _valid(case, s, rng)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    want = np.asarray(jattn._decode_attn(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(valid),
        cap).astype(jnp.float32))
    tq, tk, tv = (torch.tensor(a).to(tdt) for a in (q, k, v))
    tvalid = torch.tensor(valid)

    def no_copy(*a, **kw):
        raise AssertionError("the chunked branch copied the cache")
    with monkeypatch.context() as mp:
        for name in ("cat", "stack", "concat"):
            mp.setattr(torch, name, no_copy)
        mp.setattr(torch.nn.functional, "pad", no_copy)
        got = attention._decode_attn(tq, tk, tv, tvalid, cap)
    assert got.shape == (B, 1, KV, G, HD) and got.dtype == tdt
    got = got.float().numpy()
    assert np.all(np.isfinite(got))
    assert rel(got, want) <= TOL[dtype], rel(got, want)
    if dtype == "float32":
        whole = attention._sdpa(tq, tk, tv, tvalid[None, None, None, None],
                                cap).numpy()
        assert rel(got, whole) <= 1e-5, rel(got, whole)


def _attn_case(layer_type: str):
    """(reference config, port config, cache slots, decode index: the
    prompt's length) of one attention layer at reduced widths: "A" at 70
    slots of which 50 are filled (20 stale), "L" at its 64-token window
    after a 100-token prompt (the ring wrapped), "C" at its 64-token
    chunk at index 100 (the positions 36..63 left from the chunk
    before, stale)."""
    arch = "llama4-maverick-400b-a17b" if layer_type == "C" else "gemma2-2b"
    jcfg = jreduced(jget_arch(arch), d_model=64)
    cfg = reduced(get_arch(arch), d_model=64)
    slots, t = {"A": (70, 50), "L": (64, 100), "C": (64, 100)}[layer_type]
    return jcfg, cfg, slots, t


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cap", [50.0, 0.0])
@pytest.mark.parametrize("layer_type", ["A", "L", "C"])
def test_attn_decode_matches_reference(layer_type, cap, dtype):
    jcfg, cfg, slots, t = _attn_case(layer_type)
    jcfg, cfg = (replace(jcfg, attn_softcap=cap),
                 replace(cfg, attn_softcap=cap))
    assert attention.cache_len(cfg, layer_type, 10_000) >= slots > CHUNK
    gen = torch.Generator().manual_seed(3)
    tp = attention.init_attn(gen, cfg)
    rng = np.random.default_rng(11)
    kvh, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    k = rng.standard_normal((B, slots, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((B, slots, kvh, hd)).astype(np.float32)
    pos = np.full(slots, -1, np.int32)
    p = np.arange(max(t - slots, 0), t)
    pos[p % slots] = p
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)

    jp = {n: jnp.asarray(w.numpy(), jdt) for n, w in tp.items()}
    jcache = {"k": jnp.asarray(k, jdt), "v": jnp.asarray(v, jdt),
              "pos": jnp.asarray(pos)}
    jy, jc = jattn.attn_decode(jp, jnp.asarray(x, jdt), jcache, t,
                               cfg=jcfg, layer_type=layer_type)
    cache = {"k": torch.tensor(k).to(tdt), "v": torch.tensor(v).to(tdt),
             "pos": torch.tensor(pos)}
    y, c = attention.attn_decode({n: w.to(tdt) for n, w in tp.items()},
                                 torch.tensor(x).to(tdt), cache, t,
                                 cfg=cfg, layer_type=layer_type)
    tol = TOL[dtype]
    assert rel(y.float().numpy(), np.asarray(jy.astype(jnp.float32))) <= tol
    assert np.array_equal(c["pos"].numpy(), np.asarray(jc["pos"]))
    for name in ("k", "v"):
        assert rel(c[name].float().numpy(),
                   np.asarray(jc[name].astype(jnp.float32))) <= tol, name


def _model_cfgs(arch: str):
    """(reference config, port config): reduced gemma2-2b ("L", "A";
    softcaps 2 on the scores and the logits, so tanh bites) or llama4
    (one period C, C, C, A; MoE on 1 and 3), d_model 64."""
    if arch == "gemma2-2b":
        over = dict(attn_softcap=2.0, logit_softcap=2.0)
        return (replace(jreduced(jget_arch(arch), d_model=64), **over),
                replace(reduced(get_arch(arch), d_model=64), **over))
    return (jreduced(jget_arch(arch), d_model=64, layers=4),
            reduced(get_arch(arch), d_model=64, layers=4))


@pytest.mark.parametrize("arch", ["gemma2-2b", "llama4-maverick-400b-a17b"])
def test_greedy_decode_matches_reference(arch):
    """A 70-token prefill, then 4 greedy steps: every decode step's
    attention over an "A" cache of 74 slots (ragged in chunks of 16) and
    over "L" / "C" caches of 64 takes the chunked branch."""
    t_prompt, steps = 70, 4
    max_len = t_prompt + steps
    jcfg, cfg = _model_cfgs(arch)
    tp, jp = weights(cfg, 0)
    prompt = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, t_prompt)).astype(np.int32)
    model = Model(cfg)
    logits, cache = model.prefill(tp, {"tokens": port_tokens(prompt)},
                                  max_len)
    assert min(lc["attn"]["k"].shape[1] for lc in cache["layers"]) > CHUNK
    ref = RefDecoder(jcfg, jp)
    jlogits, jcache = ref.prefill(prompt, max_len)
    assert rel(logits.numpy(), np.asarray(jlogits)) <= 1e-4
    tok = torch.argmax(logits, -1)
    for i in range(steps):
        jtok = jnp.argmax(jlogits, -1)
        assert np.array_equal(tok.numpy(), np.asarray(jtok)), i
        logits, cache = model.decode_step(tp, cache, tok, t_prompt + i)
        jlogits, jcache = ref.decode(jcache, jtok, t_prompt + i)
        err = rel(logits.numpy(), np.asarray(jlogits))
        assert err <= 1e-4, (i, err)
        tok = torch.argmax(logits, -1)
    assert np.array_equal(tok.numpy(), np.asarray(jnp.argmax(jlogits, -1)))
