"""The port's kernels against the Pallas kernels they replace, on identical
inputs. On the CPU each wrapper runs its plain PyTorch version; it is
held against (a) the Pallas kernel run as tests/test_kernels.py runs it
(``repro.kernels.ops``, interpret mode) and its ``ref.py`` oracle, in the
TPU kernel's own mode, and (b) the reference engine's inline jnp
formulas in the per-row / per-cloud modes the port's engine uses.
Tolerances are tests/test_kernels.py's: 1e-5 in fp32, 5e-2 in bf16
(sums in another order); top-k, the codec round trip and the EF step are
exact. The CUDA kernels themselves are held against their plain
versions on the card by tests/test_torch_kernels_gpu.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress import ef_step_masked as jef_step_masked
from repro.compress.topk import TopKCodec as JTopKCodec
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.compress import ef_step_masked
from repro_torch.compress.topk import TopKCodec
from repro_torch.kernels import ops

EPS = 1e-12
_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
_JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _pair(a: np.ndarray, dtype: str):
    """The same float32 numpy values in both frameworks, rounded to
    ``dtype`` identically (round to nearest even)."""
    return jnp.asarray(a).astype(_JDT[dtype]), torch.tensor(a).to(_TDT[dtype])


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,seed", [(2, 3, 0), (7, 130, 1), (17, 300, 2)])
def test_trust_score_single_ref_matches_pallas(n, d, seed, dtype):
    rng = np.random.default_rng(seed)
    gj, gt = _pair(rng.standard_normal((n, d), np.float32), dtype)
    rj, rt = _pair(rng.standard_normal(d, np.float32), dtype)
    rep = rng.random(n).astype(np.float32)
    gbar = torch.mean(gt.float(), dim=0)
    got = ops.trust_score(gt, gbar, rt, torch.tensor(rep))
    pallas = jops.trust_score(gj, rj, jnp.asarray(rep), block_n=4,
                              block_d=128)
    oracle = jref.trust_score_ref(gj, rj, jnp.asarray(rep))
    for a, b, c in zip(got, pallas, oracle):
        _close(a, b, _TOL[dtype])
        _close(a, c, _TOL[dtype])


@pytest.mark.parametrize("seed", [0, 1])
def test_trust_score_cloud_mode_matches_engine_formulas(seed):
    """Own-cloud references gathered per row, with w-weighted ḡ: the
    engine's Eq. 7 φ (before damp) and Eq. 11 ReLU(cos) (engine.py
    718-754), and ‖g‖."""
    rng = np.random.default_rng(seed)
    m, k, L = 12, 3, 1290
    g = rng.standard_normal((m, L)).astype(np.float32)
    refs = rng.standard_normal((k, L)).astype(np.float32)
    cloud = rng.integers(0, k, m)
    w = (rng.random(m) < 0.8).astype(np.float32)
    gj, rj, wj = jnp.asarray(g), jnp.asarray(refs), jnp.asarray(w)
    gbar = (wj @ gj) / jnp.maximum(jnp.sum(wj), 1.0)
    norms = jnp.linalg.norm(gj, axis=1)
    phi_e = jax.nn.relu((gj @ gbar) / jnp.maximum(
        norms * jnp.linalg.norm(gbar), EPS)) * norms
    ref_sel = rj[cloud]
    cos_e = jax.nn.relu(jnp.sum(gj * ref_sel, axis=1) / jnp.maximum(
        norms * jnp.linalg.norm(ref_sel, axis=1), EPS))
    phi, cos, nrm = ops.trust_score(
        torch.tensor(g), torch.tensor(np.asarray(gbar)), torch.tensor(refs),
        torch.ones(m), ref_idx=torch.tensor(cloud))
    for a, b in ((phi, phi_e), (cos, cos_e), (nrm, norms)):
        _close(a, b, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,seed", [(2, 2, 0), (5, 65, 1), (12, 260, 2)])
def test_weighted_agg_single_segment_matches_pallas(n, d, seed, dtype):
    rng = np.random.default_rng(seed)
    gj, gt = _pair(rng.standard_normal((n, d), np.float32), dtype)
    ts = (rng.random(n) + 0.1).astype(np.float32)
    norms = np.linalg.norm(np.asarray(gt.float()), axis=1).astype(np.float32)
    got = ops.weighted_agg(gt, torch.tensor(ts), torch.tensor(norms),
                           torch.tensor(1.7))
    pallas = jops.weighted_agg(gj, jnp.asarray(ts), jnp.asarray(norms),
                               jnp.asarray(1.7), block_d=64)
    oracle = jref.weighted_agg_ref(gj, jnp.asarray(ts), jnp.asarray(norms),
                                   jnp.asarray(1.7))
    _close(got, pallas, _TOL[dtype])
    _close(got, oracle, _TOL[dtype])


@pytest.mark.parametrize("seed", [0, 1])
def test_weighted_agg_per_cloud_matches_engine_formulas(seed):
    """Eq. 12 rescale by the own-cloud reference norm + Eq. 13 per cloud
    (engine.py 757-764), one cloud left empty (its row stays 0)."""
    rng = np.random.default_rng(seed)
    m, k, d = 10, 4, 700
    g = rng.standard_normal((m, d)).astype(np.float32)
    cloud = rng.integers(0, k - 1, m)              # cloud k-1 is empty
    ts = (rng.random(m) * (rng.random(m) < 0.8)).astype(np.float32)
    ref_norms = (rng.random(k) + 0.5).astype(np.float32)
    gj, tsj = jnp.asarray(g), jnp.asarray(ts)
    onehot = jax.nn.one_hot(jnp.asarray(cloud), k, dtype=jnp.float32)
    row_norms = jnp.linalg.norm(gj, axis=1)
    g_tilde = gj * (jnp.asarray(ref_norms)[cloud]
                    / jnp.maximum(row_norms, EPS))[:, None]
    ts_cloud = onehot.T @ tsj
    want = (onehot.T @ (g_tilde * tsj[:, None])
            / jnp.maximum(ts_cloud, EPS)[:, None])
    got = ops.weighted_agg(torch.tensor(g), torch.tensor(ts),
                           torch.tensor(np.asarray(row_norms)),
                           torch.tensor(ref_norms),
                           seg=torch.tensor(cloud), n_seg=k)
    _close(got, want, 1e-5)
    assert not got[k - 1].any()


@pytest.mark.parametrize("n,d,k,seed", [(1, 5, 1, 0), (3, 100, 10, 1),
                                        (9, 513, 51, 2)])
def test_topk_mask_matches_pallas_exactly(n, d, k, seed):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, d)).astype(np.float32)
    g[0, :3] = g[0, 0]                      # ties at the threshold are kept
    thr = jax.lax.top_k(jnp.abs(jnp.asarray(g)), k)[0][:, -1]
    want = jops.topk_mask(jnp.asarray(g), k=k, block_n=4, block_d=128)
    got = ops.topk_mask(torch.tensor(g), torch.tensor(np.asarray(thr)))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), np.asarray(
        jref.topk_mask_ref(jnp.asarray(g), thr)))
    # the port's threshold is the same value lax.top_k gives
    assert np.array_equal(ops.row_threshold(torch.tensor(g), k).numpy(),
                          np.asarray(thr))
    # rows past thr's length take thr = +inf (the padded-row semantics)
    short = ops.topk_mask(torch.tensor(g), torch.tensor(np.asarray(thr))[:1])
    assert np.array_equal(short[:1].numpy(), got[:1].numpy())
    assert not short[1:].any()


@pytest.mark.parametrize("d,ratio,seed", [(50, 0.1, 0), (1000, 0.25, 1),
                                          (545, 1.0, 2)])
def test_topk_codec_roundtrip_and_ef_step_exact(d, ratio, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((4, d)) * 1e-3).astype(np.float32)
    res = (rng.standard_normal((4, d)) * 1e-4).astype(np.float32)
    mask = np.array([True, False, True, True])
    codec, jcodec = TopKCodec(ratio), JTopKCodec(ratio)
    assert codec.k_for(d) == jcodec.k_for(d)
    assert codec.payload_bytes(d) == jcodec.payload_bytes(d)
    assert np.array_equal(
        codec.roundtrip(torch.tensor(x)).numpy(),
        np.asarray(jcodec.roundtrip(jnp.asarray(x), None)))
    got = ef_step_masked(codec, torch.tensor(x), torch.tensor(res),
                         torch.tensor(mask))
    want = jef_step_masked(jcodec, jnp.asarray(x), jnp.asarray(res),
                           jnp.asarray(mask), None)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
