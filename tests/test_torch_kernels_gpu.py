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
