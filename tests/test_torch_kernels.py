"""The port's kernels against the Pallas kernels they replace, on identical
inputs. On the CPU each wrapper runs its plain PyTorch version; it is
held against (a) the Pallas kernel run as tests/test_kernels.py runs it
(``repro.kernels.ops``, interpret mode) and its ``ref.py`` oracle, in the
TPU kernel's own mode, and (b) the reference engine's inline jnp
formulas in the per-row / per-cloud modes the port's engine uses.
Tolerances are tests/test_kernels.py's: 1e-5 in fp32, 5e-2 in bf16
(sums in another order); top-k, the codec round trip, the EF step and
the QSGD levels and round trip are exact. The CUDA kernels themselves are held against their plain
versions on the card by tests/test_torch_kernels_gpu.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress import ef_step_masked as jef_step_masked
from repro.compress.topk import TopKCodec as JTopKCodec
from repro.core import features as jfeatures
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


@pytest.mark.parametrize("levels", [1, 15])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,seed", [(1, 3, 0), (5, 130, 1), (9, 1000, 2)])
def test_stochastic_quantize_matches_pallas_exactly(n, d, seed, dtype,
                                                    levels):
    """int32 levels equal to the Pallas kernel (interpret mode, padded
    blocks) and the oracle, a zero row included (q = 0); the fused round
    trip equals ``ref.dequantize_ref`` and its residual exactly."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, d)) * 1e-2).astype(np.float32)
    x[0] = 0.0
    xj, xt = _pair(x, dtype)
    scale = np.abs(np.asarray(xt.float())).max(axis=1)
    u = rng.random((n, d), dtype=np.float32)
    q = ops.stochastic_quantize(xt, torch.tensor(scale), torch.tensor(u),
                                levels=levels)
    pallas = jops.stochastic_quantize(xj, jnp.asarray(scale), jnp.asarray(u),
                                      levels=levels, block_n=4, block_d=128)
    oracle = jref.stochastic_quantize_ref(xj, jnp.asarray(scale),
                                          jnp.asarray(u), levels)
    assert q.dtype == torch.int32
    assert np.array_equal(q.numpy(), np.asarray(pallas))
    assert np.array_equal(q.numpy(), np.asarray(oracle))
    assert not q[0].any() and int(q.abs().max()) <= levels
    x_hat, res = ops.quantize_roundtrip(xt, torch.tensor(scale),
                                        torch.tensor(u), levels=levels)
    want = np.asarray(jref.dequantize_ref(pallas, jnp.asarray(scale),
                                          levels))
    assert np.array_equal(x_hat.numpy(), want)
    assert np.array_equal(res.numpy(), np.asarray(xt.float()) - want)


def _features_inputs(m, d, seed, dtype):
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((m, d)).astype(np.float32)
    refs = rng.standard_normal((m, d)).astype(np.float32)
    gj, gt = _pair(g, dtype)
    rj, rt = _pair(refs, dtype)
    w = (rng.random(m) < 0.8).astype(np.float32)
    gbar = (w @ np.asarray(gt.float())) / max(w.sum(), 1.0)
    norms = np.linalg.norm(np.asarray(gt.float()), axis=1)
    med = np.float32(np.median(norms))
    return gj, gt, rj, rt, gbar.astype(np.float32), med, w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,d,seed,case", [
    (1, 7, 0, "plain"), (7, 130, 1, "plain"), (12, 1290, 2, "plain"),
    (6, 300, 3, "all_masked"), (5, 200, 4, "nan_med"),
    (5, 200, 5, "zero_med")])
def test_trust_features_matches_pallas(m, d, seed, case, dtype):
    """Features equal to the Pallas kernel (interpret mode, padded
    blocks) and its oracle within 1e-5 fp32 / 5e-2 bf16: one row, every
    row masked (all zero), and a NaN or zero median (sanitized to 1)."""
    gj, gt, rj, rt, gbar, med, w = _features_inputs(m, d, seed, dtype)
    if case == "all_masked":
        w[:] = 0.0
    med = {"nan_med": np.float32(np.nan), "zero_med": np.float32(0.0)
           }.get(case, med)
    got = ops.trust_features(gt, rt, torch.tensor(gbar), torch.tensor(med),
                             torch.tensor(w))
    pallas = jops.trust_features(gj, rj, jnp.asarray(gbar), jnp.asarray(med),
                                 jnp.asarray(w), block_n=4, block_d=128)
    oracle = jref.trust_features_ref(gj, rj, jnp.asarray(gbar),
                                     jnp.asarray(med), jnp.asarray(w))
    assert got.shape == (m, 4) and got.dtype == torch.float32
    _close(got, pallas, _TOL[dtype])
    _close(got, oracle, _TOL[dtype])
    if case == "all_masked":
        assert not got.any()


@pytest.mark.parametrize("seed", [0, 1])
def test_trust_features_cloud_mode_matches_client_features(seed):
    """Own-cloud references gathered per row through ``ref_idx``: the
    engine's call, ``client_features(ll, ref_ll[cloud], …)``."""
    rng = np.random.default_rng(seed)
    m, k, L = 12, 3, 1290
    g = rng.standard_normal((m, L)).astype(np.float32)
    refs = rng.standard_normal((k, L)).astype(np.float32)
    cloud = rng.integers(0, k, m)
    w = (rng.random(m) < 0.8).astype(np.float32)
    gbar = (w @ g) / max(w.sum(), 1.0)
    med = np.float32(np.median(np.linalg.norm(g, axis=1)))
    want = jfeatures.client_features(
        jnp.asarray(g), jnp.asarray(refs)[cloud], jnp.asarray(gbar),
        jnp.asarray(med), jnp.asarray(w))
    got = ops.trust_features(torch.tensor(g), torch.tensor(refs),
                             torch.tensor(gbar), torch.tensor(med),
                             torch.tensor(w), ref_idx=torch.tensor(cloud))
    _close(got, want, 1e-5)


# linear_scan: tests/test_kernels.py's property-style shapes (B 1–5,
# T 1–70, D 1–40) at fixed seeds, through the wrapper (the plain
# log-depth scan on the CPU). fp32 within 2e-5 (tests/test_kernels.py's
# tolerance: three scan orders), bf16 within 5e-2.
_SCAN_SHAPES = [(1, 1, 1), (2, 9, 3), (3, 33, 17), (4, 64, 32), (5, 70, 40),
                (1, 70, 1), (2, 2, 40)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,d", _SCAN_SHAPES)
def test_linear_scan_matches_pallas_and_ref(b, t, d, dtype):
    rng = np.random.default_rng(10_000 * b + 100 * t + d)
    aj, at = _pair(rng.uniform(0.1, 0.99, (b, t, d)).astype(np.float32),
                   dtype)
    xj, xt = _pair(rng.standard_normal((b, t, d)).astype(np.float32), dtype)
    got = ops.linear_scan(at, xt)
    assert got.shape == (b, t, d) and got.dtype == _TDT[dtype]
    got = got.float()
    tol = 2e-5 if dtype == "float32" else _TOL[dtype]
    _close(got, jops.linear_scan(aj, xj, chunk=16, block_b=2), tol)
    _close(got, jref.linear_scan_ref(aj, xj), tol)


def test_linear_scan_is_true_recurrence():
    """Directed: against an explicit loop (tests/test_kernels.py)."""
    rng = np.random.default_rng(0)
    a = rng.uniform(0.5, 0.95, (2, 9, 3)).astype(np.float32)
    b = rng.normal(size=(2, 9, 3)).astype(np.float32)
    h = np.zeros((2, 3), np.float32)
    expect = np.zeros_like(b)
    for t in range(9):
        h = a[:, t] * h + b[:, t]
        expect[:, t] = h
    out = ops.linear_scan(torch.tensor(a), torch.tensor(b))
    np.testing.assert_allclose(out.numpy(), expect, rtol=1e-5, atol=1e-6)


def _clustered_scan_np(a, b, max_rows, cluster=4, warps=8, lanes=32):
    """numpy emulation, in fp32, of how csrc/linear_scan.cu splits the
    scan: channel tiles of ``lanes``; per segment of T, ``cluster``
    blocks of ``warps`` sub-chunks of ``rows`` steps (the fewest that
    cover T in one segment, at most ``max_rows``); each sub-chunk scanned
    from zero into (prod a, h_end); a block's warp summaries folded in
    order into prefixes and the block's summary; the cluster's summaries
    folded in rank order into each block's incoming state and the
    segment's end state (the next segment's h_{-1}); every sub-chunk
    rerun from its incoming state. Returns h and the number of writes of
    each (b, t, d)."""
    def cdiv(x, y):
        return -(-x // y)

    bsz, t_len, d_len = a.shape
    rows = min(max_rows, cdiv(cdiv(t_len, cluster), warps))
    tc = warps * rows
    n_seg = cdiv(t_len, cluster * tc)
    h = np.zeros_like(a)
    writes = np.zeros(a.shape, np.int64)
    for d0 in range(0, d_len, lanes):
        ch = slice(d0, min(d0 + lanes, d_len))
        one = np.ones((bsz, ch.stop - d0), np.float32)
        carry = 0 * one
        for seg in range(n_seg):
            prefixes, blocks = [], []
            for rank in range(cluster):
                pa, ph, pre = one, 0 * one, []
                for w in range(warps):
                    t0 = (seg * cluster + rank) * tc + w * rows
                    n = max(0, min(rows, t_len - t0))
                    wa, wh = one, 0 * one
                    for i in range(t0, t0 + n):
                        ai = a[:, i, ch]
                        wa, wh = wa * ai, ai * wh + b[:, i, ch]
                    pre.append((t0, n, pa, ph))
                    pa, ph = pa * wa, wa * ph + wh
                prefixes.append(pre)
                blocks.append((pa, ph))
            incoming = []
            for pa, ph in blocks:
                incoming.append(carry)
                carry = pa * carry + ph
            for rank, pre in enumerate(prefixes):
                for t0, n, pa, ph in pre:
                    state = pa * incoming[rank] + ph
                    for i in range(t0, t0 + n):
                        state = a[:, i, ch] * state + b[:, i, ch]
                        h[:, i, ch] = state
                        writes[:, i, ch] += 1
    return h, writes


@pytest.mark.parametrize("b,t,d,max_rows", [
    pytest.param(2, 3, 33, 32, id="T<cluster"),
    pytest.param(1, 1000, 130, 32, id="T-ragged-one-segment"),
    pytest.param(2, 3 * 4 * 8 * 4 + 7, 40, 4, id="four-segments"),
    pytest.param(3, 70, 13, 32, id="D-not-8Z"),
    pytest.param(1, 4096, 3, 32, id="serving-T-bf16-tiles"),
    pytest.param(1, 4096, 3, 16, id="serving-T-fp32-tiles"),
])
def test_clustered_scan_decomposition_matches_ref(b, t, d, max_rows):
    """The kernel's decomposition (emulated above; max_rows 32 is its
    bf16 tile, 16 its fp32 tile — 4 and 8 segments at T = 4096 — and 4 a
    small tile that makes T = 391 four segments) covers every (b, t, d)
    once and gives ``ref.linear_scan_ref``'s h within 2e-5 (fp32, another
    order)."""
    rng = np.random.default_rng(7 * t + d)
    a = rng.uniform(0.1, 0.99, (b, t, d)).astype(np.float32)
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    got, writes = _clustered_scan_np(a, x, max_rows)
    assert got.dtype == np.float32 and (writes == 1).all()
    _close(got, jref.linear_scan_ref(jnp.asarray(a), jnp.asarray(x)), 2e-5)


@pytest.mark.parametrize("case", ["shape", "dtype", "mixed", "layout"])
def test_linear_scan_refuses_off_cpu_what_the_kernel_does_not_take(case):
    """Off the CPU the wrapper checks and launches, never falls back to
    the plain version: (meta tensors reach the checks without a card)."""
    a = torch.empty(2, 8, 4, device="meta")
    b = {"shape": torch.empty(2, 8, 5, device="meta"),
         "dtype": torch.empty(2, 8, 4, device="meta", dtype=torch.float16),
         "mixed": torch.empty(2, 8, 4, device="meta", dtype=torch.bfloat16),
         "layout": torch.empty(2, 4, 8, device="meta").transpose(1, 2)}[case]
    if case == "dtype":
        a = a.to(torch.float16)
    before = ops.linear_scan.launches
    with pytest.raises(ValueError, match="linear_scan"):
        ops.linear_scan(a, b)
    assert ops.linear_scan.launches == before
    with pytest.raises(ValueError, match="linear_scan"):
        ops.linear_scan(torch.zeros(2, 8, 4), torch.zeros(2, 8, 4,
                                                          device="meta"))
