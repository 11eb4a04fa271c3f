"""Each CUDA kernel of ``repro_torch`` against its plain PyTorch version
on the card, at the main path's shapes. Imports neither JAX nor the JAX
package, so it runs on the GPU machine:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_kernels_gpu.py

(``--noconftest``: the suite's conftest imports JAX). Without a CUDA
device every test skips. Tolerances: 1e-5 in fp32 and 5e-2 in bf16
(sums in another order), top-k exact."""
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
