"""Each CUDA kernel of ``repro_torch`` against its plain PyTorch version
on the card, at the main path's shapes. Imports neither JAX nor the JAX
package, so it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_kernels_gpu.py

(``--noconftest``: the suite's conftest imports JAX). Without a CUDA
device every test skips. Tolerances: 1e-5 in fp32 and 5e-2 in bf16
(sums and scans in another order); top-k and QSGD (levels and round
trip) exact."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops

_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
_TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(),
                               rtol=tol, atol=tol)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels are built and run "
                    "only on the GPU")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_trust_score_matches_plain(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(0)
    g = torch.randn(30, 1290, generator=gen, device=cuda).to(_TDT[dtype])
    refs = torch.randn(3, 1290, generator=gen, device=cuda).to(_TDT[dtype])
    rep = torch.rand(30, generator=gen, device=cuda)
    idx = torch.arange(3, device=cuda).repeat_interleave(10)
    gbar = g.float().mean(0)
    before = ops.trust_score.launches
    for ref, ix in ((refs, idx), (refs[1], None)):
        got = ops.trust_score(g, gbar, ref, rep, ref_idx=ix)
        want = ops.trust_score_plain(g, gbar, ref, rep, ref_idx=ix)
        for a, b in zip(got, want):
            _close(a, b, _TOL[dtype])
    assert ops.trust_score.launches == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_weighted_agg_matches_plain(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(1)
    g = torch.randn(30, 545_098, generator=gen, device=cuda).to(_TDT[dtype])
    ts = torch.rand(30, generator=gen, device=cuda) + 0.1
    norms = torch.linalg.vector_norm(g.float(), dim=1)
    ref_norm = torch.rand(3, generator=gen, device=cuda) + 1.0
    seg = torch.arange(3, device=cuda).repeat_interleave(10)
    for sg, n_seg in ((seg, 3), (None, 1)):
        got = ops.weighted_agg(g, ts, norms, ref_norm[:n_seg], seg=sg,
                               n_seg=n_seg)
        want = ops.weighted_agg_plain(g, ts, norms, ref_norm[:n_seg],
                                      seg=sg, n_seg=n_seg)
        _close(got, want, _TOL[dtype])


@pytest.mark.gpu
def test_cuda_topk_mask_matches_plain_exactly(cuda):
    gen = torch.Generator(device=cuda).manual_seed(2)
    y = torch.randn(3, 545_098, generator=gen, device=cuda) * 1e-3
    thr = ops.row_threshold(y, 54_510)
    for f16 in (False, True):
        assert torch.equal(ops.topk_mask(y, thr, fp16_roundtrip=f16),
                           ops.topk_mask_plain(y, thr, fp16_roundtrip=f16))
    yb = y.to(torch.bfloat16)
    assert torch.equal(ops.topk_mask(yb, thr[:2]),
                       ops.topk_mask_plain(yb, thr[:2]))


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [30, 3])
def test_cuda_stochastic_quantize_matches_plain_exactly(cuda, rows):
    gen = torch.Generator(device=cuda).manual_seed(3)
    y = torch.randn(rows, 545_098, generator=gen, device=cuda) * 1e-3
    y[0] = 0.0                                    # a zero row: q = 0
    u = torch.rand(rows, 545_098, generator=gen, device=cuda)
    scale = torch.amax(y.abs(), dim=1)
    before = ops.stochastic_quantize.launches
    for levels in (1, 15):
        assert torch.equal(
            ops.stochastic_quantize(y, scale, u, levels=levels),
            ops.stochastic_quantize_plain(y, scale, u, levels))
        for a, b in zip(ops.quantize_roundtrip(y, scale, u, levels=levels),
                        ops.quantize_roundtrip_plain(y, scale, u, levels)):
            assert torch.equal(a, b)
    yb = y.to(torch.bfloat16)
    assert torch.equal(ops.stochastic_quantize(yb, scale, u, levels=15),
                       ops.stochastic_quantize_plain(yb, scale, u, 15))
    assert ops.stochastic_quantize.launches == before + 5


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_trust_features_matches_plain(cuda, dtype):
    gen = torch.Generator(device=cuda).manual_seed(4)
    g = torch.randn(30, 1290, generator=gen, device=cuda).to(_TDT[dtype])
    refs = torch.randn(3, 1290, generator=gen, device=cuda).to(_TDT[dtype])
    idx = torch.arange(3, device=cuda).repeat_interleave(10)
    w = (torch.rand(30, generator=gen, device=cuda) < 0.8).float()
    gbar = (w @ g.float()) / w.sum().clamp(min=1.0)
    med = torch.linalg.vector_norm(g.float(), dim=1).median()
    nan = torch.tensor(float("nan"), device=cuda)
    before = ops.trust_features.launches
    for r, ix, md in ((refs, idx, med), (refs[idx], None, med),
                      (refs, idx, nan), (refs, idx, med * 0)):
        _close(ops.trust_features(g, r, gbar, md, w, ref_idx=ix),
               ops.trust_features_plain(g, r, gbar, md, w, ref_idx=ix),
               _TOL[dtype])
    assert ops.trust_features.launches == before + 4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d", [(4096, 2560), (1000, 130), (31, 33),
                                 (1, 1)])
def test_cuda_linear_scan_matches_plain(cuda, dtype, t, d):
    """B = 1 as the serving prefill gives it, at its shape and at ragged
    T (not a multiple of a cluster's steps) and D (not of the 32
    channels a block; rows not 16-byte aligned at 130, 33 and 1)."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    a = (0.1 + 0.89 * torch.rand(1, t, d, generator=gen, device=cuda)
         ).to(_TDT[dtype])
    b = torch.randn(1, t, d, generator=gen, device=cuda).to(_TDT[dtype])
    before = ops.linear_scan.launches
    got = ops.linear_scan(a, b)
    assert got.dtype == _TDT[dtype] and got.shape == (1, t, d)
    _close(got, ops.linear_scan_plain(a, b), _TOL[dtype])
    assert ops.linear_scan.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bsz,t,d", [(1, 12_295, 64), (3, 1000, 130)])
def test_cuda_linear_scan_segments_and_batch_match_plain(cuda, dtype, bsz,
                                                         t, d):
    """T = 12,295 runs a cluster over many segments (a segment is at most
    4 blocks * 8 warps * 32 steps = 1,024 steps in bf16, 512 in fp32),
    the carry from one segment to the next included; B = 3 rides on
    gridDim.z at a ragged D."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    a = (0.1 + 0.89 * torch.rand(bsz, t, d, generator=gen, device=cuda)
         ).to(_TDT[dtype])
    b = torch.randn(bsz, t, d, generator=gen, device=cuda).to(_TDT[dtype])
    before = ops.linear_scan.launches
    got = ops.linear_scan(a, b)
    assert got.dtype == _TDT[dtype] and got.shape == (bsz, t, d)
    _close(got, ops.linear_scan_plain(a, b), _TOL[dtype])
    assert ops.linear_scan.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bsz,t,d", [(1, 4096, 2560), (3, 1000, 130),
                                     (2, 1, 33)])
def test_cuda_linear_scan_backward_matches_plain(cuda, dtype, bsz, t, d):
    """``LinearScan``'s backward on the card (the reverse scan, one launch
    of the same kernel, counted by ``linear_scan_bwd``) against autograd
    through ``linear_scan_plain``: ∂a and ∂b within 1e-5 in fp32 and
    5e-2 in bf16 (g is rounded to bf16 once, then ∂a once more). T = 1:
    ∂a is 0."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    a = (0.1 + 0.89 * torch.rand(bsz, t, d, generator=gen, device=cuda)
         ).to(_TDT[dtype])
    b = torch.randn(bsz, t, d, generator=gen, device=cuda).to(_TDT[dtype])
    dh = torch.randn(bsz, t, d, generator=gen, device=cuda).to(_TDT[dtype])
    ar, br = a.clone().requires_grad_(), b.clone().requires_grad_()
    before = (ops.linear_scan.launches, ops.linear_scan_bwd.launches)
    h = ops.linear_scan(ar, br)
    assert h.grad_fn is not None
    da, db = torch.autograd.grad(h, (ar, br), dh)
    assert (ops.linear_scan.launches, ops.linear_scan_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    ap, bp = a.clone().requires_grad_(), b.clone().requires_grad_()
    want = torch.autograd.grad(ops.linear_scan_plain(ap, bp), (ap, bp), dh,
                               allow_unused=True, materialize_grads=True)
    assert da.dtype == db.dtype == _TDT[dtype]
    _close(db, want[1], _TOL[dtype])
    _close(da, want[0], _TOL[dtype])


@pytest.mark.gpu
def test_cuda_two_runs_of_one_seed_are_identical(cuda):
    """Two same-seed ``run_simulation`` runs of the headline path on the
    card (full width, 3 rounds), with cuDNN left by the caller on
    PyTorch's defaults (any algorithm, the autotuner on): the entry point
    restricts it to deterministic algorithms itself, so the round lines
    (masks, bytes, $, digests) are identical, the reputation equal and the
    final params equal bit for bit."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.federated import make_data, run_simulation, simulation
    from repro_torch.telemetry import ListSink, Telemetry, encode

    fl = FLConfig(attack="label_flip", malicious_frac=0.3, compressor="topk",
                  compress_ratio=0.1, link_policy="cross_only")
    data = make_data(fl)
    runs = []
    make = simulation.FLServer
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    try:
        for _ in range(2):
            made = []

            def build(*args, **kw):
                made.append(make(*args, **kw))
                return made[-1]
            simulation.FLServer = build
            torch.backends.cudnn.deterministic = False
            torch.backends.cudnn.benchmark = True
            sink = ListSink()
            res = run_simulation(fl, rounds=3, eval_every=3, data=data,
                                 device=cuda, engine="jit",
                                 telemetry=Telemetry(sink))
            assert torch.backends.cudnn.deterministic
            assert not torch.backends.cudnn.benchmark
            runs.append((res, [encode(e) for e in sink.events
                               if e["event"] == "round"],
                         {k: v.cpu() for k, v in made[0].params.items()}))
    finally:
        simulation.FLServer = make
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
    (r0, lines0, p0), (r1, lines1, p1) = runs
    assert len(lines0) == 3 and lines0 == lines1
    assert (r0.total_cost, r0.intra_bytes, r0.cross_bytes) == \
        (r1.total_cost, r1.intra_bytes, r1.cross_bytes)
    assert np.array_equal(r0.reputation, r1.reputation)
    assert p0.keys() == p1.keys()
    assert all(torch.equal(p0[k], p1[k]) for k in p0)


def _stage_inputs(cuda, m, d, lo, length, case, seed=7, k=3, spread=True):
    """Trust-stage inputs on the card: the wire (m, d) with the last layer
    at [lo, lo + length), its rows' norms and alignments with their
    references spread evenly (nearly equal features would make the
    separability ill-conditioned, tests/test_torch_trust_stage.py), or
    with ``spread=False`` drawn uniformly over the same ranges."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    n = 3 * m                                  # clients
    flat = torch.randn(m, d, generator=gen, device=cuda)
    refs = torch.randn(k, d, generator=gen, device=cuda)
    cloud = torch.randint(0, k, (m,), generator=gen, device=cuda)
    if spread:
        scale = torch.logspace(-0.5229, 0.4771, m, device=cuda)  # 0.3 .. 3
        align = torch.linspace(-0.5, 1.5, m, device=cuda)
        scale = scale[torch.randperm(m, generator=gen, device=cuda)]
        align = align[torch.randperm(m, generator=gen, device=cuda)]
    else:
        scale = 0.3 + 2.7 * torch.rand(m, generator=gen, device=cuda)
        align = -0.5 + 2.0 * torch.rand(m, generator=gen, device=cuda)
    flat[:, lo:lo + length] = scale[:, None] * (
        align[:, None] * refs[cloud, lo:lo + length]
        + torch.randn(m, length, generator=gen, device=cuda))
    w = torch.ones(m, device=cuda)
    if case == "all_zero":
        w[:] = 0.0
    elif case == "three":
        w[3:] = 0.0
    else:
        w[1::4] = 0.0
    rep = 0.01 + 0.19 * torch.rand(n, generator=gen, device=cuda)
    sel = torch.sort(torch.randperm(n, generator=gen, device=cuda)[:m])[0]
    feat_sep = torch.rand(4, generator=gen, device=cuda)
    return (flat, refs, lo, length, cloud, w, rep, sel, 0.9, n), feat_sep


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["some_zero", "all_zero"])
@pytest.mark.parametrize("multi", [False, True], ids=["scalar", "multi"])
@pytest.mark.parametrize("m,d,lo,length", [
    (30, 545_098, 543_808, 1290),      # the main path: float2 loads
    (1, 9, 5, 1), (7, 20, 6, 10), (33, 1300, 5, 1291), (2, 1297, 7, 1290),
    (300, 2000, 3, 1500)])
def test_cuda_trust_stage_matches_plain(cuda, m, d, lo, length, multi,
                                        case):
    """The fused stage against its plain version: floats within 1e-5,
    gbar and f2 exact, the median within 1e-6 relative (NaN when no row
    delivers); ragged widths, odd column offsets (plain loads) and
    m = 300 (several row chunks, tiles in device memory)."""
    args, feat_sep = _stage_inputs(cuda, m, d, lo, length, case)
    kw = dict(feat_sep=feat_sep if multi else None)
    before = ops.trust_stage.launches
    got = ops.trust_stage(*args, **kw)
    want = ops.trust_stage_plain(*args, **kw)
    assert ops.trust_stage.launches == before + 1
    for name in ("phi", "ts", "rep_sel", "norms", "feats", "new_sep",
                 "feat_w"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            _close(a, b, 1e-5)
    assert torch.equal(got.gbar, want.gbar)
    if multi:
        assert torch.equal(got.feats[:, 2], want.feats[:, 2])
    if case == "all_zero":
        assert torch.isnan(got.med) and torch.isnan(want.med)
    else:
        np.testing.assert_allclose(float(got.med), float(want.med),
                                   rtol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["some_zero", "three"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cuda_trust_stage_random_draws_within_conditioning(cuda, seed, case):
    """Norms and alignments drawn at random (every row delivering but a
    quarter, or three rows): the separability may be ill-conditioned
    (ROADMAP.md C), so new_sep is held to what one ulp of the features
    gives through the one-pass variance (4 ulp times E[x^2] / var(x) of
    the feature and the anchor, half of it through the EMA) and the
    feature weights to 1/T = 5 times that; gbar and f2 exact, the
    features within 1e-5."""
    args, feat_sep = _stage_inputs(cuda, 30, 545_098, 543_808, 1290, case,
                                   seed=seed, spread=False)
    got = ops.trust_stage(*args, feat_sep=feat_sep)
    want = ops.trust_stage_plain(*args, feat_sep=feat_sep)
    assert torch.equal(got.gbar, want.gbar)
    assert torch.equal(got.feats[:, 2], want.feats[:, 2])
    _close(got.feats, want.feats, 1e-5)
    _close(got.norms, want.norms, 1e-5)
    w = args[5].cpu().numpy()
    f = want.feats.double().cpu().numpy()[w > 0]
    mean, sq = f.mean(0), (f * f).mean(0)
    var = sq - mean * mean
    # a feature that is 0 in every delivered row: 0 on both sides
    kappa = np.divide(sq, var, out=np.where(sq > 0, np.inf, 0.0),
                      where=var > 0)
    kappa = np.maximum(kappa, kappa[1])          # the anchor, f1
    bound = 2 * np.finfo(np.float32).eps * kappa + 1e-6
    gap = (got.new_sep - want.new_sep).abs().cpu().numpy()
    assert (gap <= bound).all(), (gap, bound)
    gap_w = float((got.feat_w - want.feat_w).abs().max())
    assert gap_w <= 5 * bound.max(), (gap_w, bound)


@pytest.mark.gpu
def test_cuda_trust_stage_floor_launches(cuda):
    from repro_torch.kernels.trust_stage import launch_floor
    for cluster in (False, True):
        launch_floor(cuda, cluster)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_trust_modes_read_device_memory_past_shared_memory(cuda, dtype):
    """A slice too wide for shared memory (L = 200,001: 25,001 columns a
    block) takes the kernel's device-memory path in both standalone
    modes; odd L, so 4-byte copies, a ragged last slice."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    m, L = 5, 200_001
    g = torch.randn(m, L, generator=gen, device=cuda).to(_TDT[dtype])
    refs = torch.randn(m, L, generator=gen, device=cuda).to(_TDT[dtype])
    rep = torch.rand(m, generator=gen, device=cuda)
    w = torch.ones(m, device=cuda)
    w[2] = 0.0
    gbar = (w @ g.float()) / w.sum()
    med = torch.linalg.vector_norm(g.float(), dim=1).median()
    for a, b in zip(ops.trust_score(g, gbar, refs[0].float(), rep),
                    ops.trust_score_plain(g, gbar, refs[0].float(), rep)):
        _close(a, b, _TOL[dtype])
    _close(ops.trust_features(g, refs, gbar, med, w),
           ops.trust_features_plain(g, refs, gbar, med, w), _TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("zero_rows", [False, True])
def test_cuda_fltrust_runs_the_unsegmented_weighted_agg(cuda, zero_rows):
    """FLTrust's aggregate at the flat path's (30, 545,098): one launch of
    ``weighted_agg`` without segments, against the plain version on the
    same card; rows zeroed as dropout zeroes them get TS = 0."""
    from repro_torch.core import robust
    gen = torch.Generator(device=cuda).manual_seed(9)
    g = torch.randn(30, 545_098, generator=gen, device=cuda) * 1e-2
    ref = g.mean(0) + torch.randn(545_098, generator=gen, device=cuda) * 1e-2
    if zero_rows:
        g[[3, 17]] = 0.0
    norms = torch.linalg.vector_norm(g, dim=1)
    refn = torch.linalg.vector_norm(ref)
    ts = torch.relu((g @ ref) / torch.clamp(norms * refn, min=1e-12))
    before = ops.weighted_agg.launches
    got = robust.fltrust(g, ref)
    assert ops.weighted_agg.launches == before + 1
    _close(got, ops.weighted_agg_plain(g, ts, norms, refn), 1e-5)
    assert got.shape == (545_098,)


@pytest.mark.gpu
def test_cuda_topk_mask_on_the_flat_client_rows(cuda):
    """The flat client wire's (30, 545,098) rows, k = 54,510 a row: the
    mask and its fp16 round trip exact, and the codec's round trip one
    ``topk_mask`` launch."""
    from repro_torch.compress import TopKCodec
    gen = torch.Generator(device=cuda).manual_seed(10)
    y = torch.randn(30, 545_098, generator=gen, device=cuda) * 1e-3
    thr = ops.row_threshold(y, 54_510)
    for f16 in (False, True):
        assert torch.equal(ops.topk_mask(y, thr, fp16_roundtrip=f16),
                           ops.topk_mask_plain(y, thr, fp16_roundtrip=f16))
    before = ops.topk_mask.launches
    got = TopKCodec(0.1).roundtrip(y)
    assert ops.topk_mask.launches == before + 1
    assert torch.equal(got, ops.topk_mask_plain(y, thr, fp16_roundtrip=True))
    assert int((got != 0).sum(1).min()) >= 54_510


@pytest.mark.gpu
def test_cuda_order_statistic_baselines_match_the_cpu(cuda):
    """Krum, the trimmed mean and the median are plain PyTorch: the card
    against the CPU on the same (30, 4099) rows — the median exact (a
    sort and one midpoint), the others within 1e-5."""
    from repro_torch.core import robust
    g = torch.tensor(np.random.default_rng(11).standard_normal(
        (30, 4099)).astype(np.float32))
    gc = g.to(cuda)
    assert torch.equal(robust.coordinate_median(gc).cpu(),
                       robust.coordinate_median(g))
    _close(robust.trimmed_mean(gc, 0.15), robust.trimmed_mean(g, 0.15), 1e-5)
    _close(robust.krum(gc, 9, multi=19), robust.krum(g, 9, multi=19), 1e-5)
