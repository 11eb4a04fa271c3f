"""The trust stage of the Cost-TrustFL round in one launch: Eq. 7 with the
median damp, the multi-feature gate, the Eq. 8–9 reputation EMA and
Eq. 11's trust, over the last layer of the round's wire view (CUDA source
``csrc/trust_stage.cu``), with its plain PyTorch version. The kernel is
the Hopper port of the Pallas kernels
``repro/kernels/trust_score.py:trust_score`` and
``repro/kernels/trust_features.py:trust_features``, fused with the plain
tensor code the reference runs around them
(``repro/federated/engine.py:711-752``); ``trust_score`` and
``trust_features`` launch its two standalone modes.

The stage reads the wire ``flat`` (m, D) and the references ``refs``
(K, D) in place at the last layer's columns ``[lo, lo + L)``; every sum
it forms is independent of the columns' order, so any contiguous range
holding the layer will do.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from repro_torch.core import features as feats_mod
from repro_torch.kernels import _build
from repro_torch.kernels.trust_features import trust_features_plain
from repro_torch.kernels.trust_score import trust_score_plain

Tensor = torch.Tensor
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MODE_SCORE, MODE_FEATURES, MODE_STAGE = 0, 1, 2
REF_SINGLE, REF_ROWS, REF_INDEXED = 0, 1, 2
MAX_REFS = 8            # clouds: weighted_agg's segment limit
CLUSTER = 8             # blocks of the clustered launch
STASH = 10              # floats a row of the kernel's scratch (kStash)
EPS = 1e-12


class TrustStage(NamedTuple):
    """The stage's outputs; the last three are None under ``scalar``."""
    phi: Tensor            # (m,) Eq. 7 contribution, damped, times w (and the gate)
    ts: Tensor             # (m,) Eq. 11 trust cos_ref · rep_sel · w
    rep_sel: Tensor        # (m,) Eq. 8–9 reputation of the selected rows
    norms: Tensor          # (m,) ‖g‖ over the last layer
    med: Tensor            # () median ‖g‖ over delivered rows (NaN if none)
    gbar: Tensor           # (L,) delivered mean of the last layer
    feats: Optional[Tensor] = None      # (m, 4) features times w
    new_sep: Optional[Tensor] = None    # (4,) separability EMA
    feat_w: Optional[Tensor] = None     # (4,) feature mixing weights


def ordered_mean(g: Tensor, w: Tensor) -> Tensor:
    """Σᵢ wᵢ·gᵢ / max(Σw, 1) with the rows added in ascending order, one
    fp32 product and one add each — the kernel's bits."""
    acc = torch.zeros(g.shape[1], dtype=torch.float32, device=g.device)
    sw = torch.zeros((), dtype=torch.float32, device=g.device)
    prod = w[:, None] * g
    for i in range(g.shape[0]):
        acc = acc + prod[i]
        sw = sw + w[i]
    return acc / torch.clamp(sw, min=1.0)


def check_stage_inputs(flat: Tensor, refs: Tensor, lo: int, length: int,
                       ref_idx: Tensor, w: Tensor, rep_ema: Tensor,
                       sel_idx: Tensor,
                       feat_sep: Optional[Tensor] = None) -> None:
    """Raise ``ValueError`` on what the kernel does not take. Index
    values are checked only on the CPU (no device sync); on the card an
    index out of range gives NaN in its row."""
    if flat.dim() != 2 or refs.dim() != 2:
        raise ValueError(f"trust_stage: flat {tuple(flat.shape)} and refs "
                         f"{tuple(refs.shape)} must be 2-D")
    m, d = flat.shape
    k = refs.shape[0]
    if flat.dtype != torch.float32 or refs.dtype != torch.float32:
        raise ValueError(f"trust_stage: flat {flat.dtype} / refs "
                         f"{refs.dtype}; the stage takes float32")
    if not (flat.is_contiguous() and refs.is_contiguous()):
        raise ValueError("trust_stage: flat and refs must be contiguous")
    if refs.shape[1] != d:
        raise ValueError(f"trust_stage: refs {tuple(refs.shape)} are not "
                         f"rows of the wire's width {d}")
    if not (0 <= lo and length >= 1 and lo + length <= d):
        raise ValueError(f"trust_stage: columns [{lo}, {lo + length}) "
                         f"outside [0, {d})")
    if not 1 <= k <= MAX_REFS:
        raise ValueError(f"trust_stage: {k} references; the kernel takes "
                         f"1 to {MAX_REFS}")
    if m < 1:
        raise ValueError("trust_stage: no rows")
    for name, t in (("ref_idx", ref_idx), ("w", w), ("sel_idx", sel_idx)):
        if t.shape != (m,):
            raise ValueError(f"trust_stage: {name} {tuple(t.shape)} does "
                             f"not fit {m} rows")
    for name, t in (("ref_idx", ref_idx), ("sel_idx", sel_idx)):
        if t.dtype.is_floating_point or t.dtype == torch.bool:
            raise ValueError(f"trust_stage: {name} must be integer")
    if rep_ema.dim() != 1:
        raise ValueError(f"trust_stage: rep_ema {tuple(rep_ema.shape)} "
                         "must be 1-D")
    if feat_sep is not None and feat_sep.shape != (feats_mod.N_FEATURES,):
        raise ValueError(f"trust_stage: feat_sep {tuple(feat_sep.shape)} "
                         f"!= ({feats_mod.N_FEATURES},)")
    tensors = [flat, refs, ref_idx, w, rep_ema, sel_idx]
    if feat_sep is not None:
        tensors.append(feat_sep)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("trust_stage: inputs on more than one device")
    if flat.device.type == "cpu":
        if bool(((ref_idx < 0) | (ref_idx >= k)).any()):
            raise ValueError(f"trust_stage: a cloud index outside [0, {k})")
        n = rep_ema.shape[0]
        if bool(((sel_idx < 0) | (sel_idx >= n)).any()):
            raise ValueError(f"trust_stage: a selected index outside "
                             f"[0, {n})")


def trust_stage_plain(flat: Tensor, refs: Tensor, lo: int, length: int,
                      ref_idx: Tensor, w: Tensor, rep_ema: Tensor,
                      sel_idx: Tensor, gamma: float, n: int,
                      feat_sep: Optional[Tensor] = None,
                      eps: float = EPS) -> TrustStage:
    """The stage in plain tensor ops: the round engine's code between the
    wire and the aggregation (``feat_sep`` given: the multi-feature
    gate)."""
    g = flat[:, lo:lo + length].to(torch.float32)
    r = refs[:, lo:lo + length].to(torch.float32)
    w = w.to(torch.float32)
    ref_idx = ref_idx.long()
    gbar = ordered_mean(g, w)
    # Eq. 7 + 11 statistics: phi, ReLU(cos(g, own cloud ref)) (reputation
    # 1 — Eq. 11 needs the POST-EMA rep), ‖g‖
    phi, cos_ref, norms = trust_score_plain(g, gbar, r, torch.ones_like(w),
                                            ref_idx=ref_idx, eps=eps)
    # median damp (jnp.nanmedian averages the middle pair; so does the 0.5
    # quantile, unlike torch.nanmedian)
    med = torch.nanquantile(
        torch.where(w > 0, norms, torch.full_like(norms, float("nan"))), 0.5)
    damp = torch.clamp((med / torch.clamp(norms, min=eps)) ** 2, max=1.0)
    damp = torch.where(torch.isnan(damp), torch.ones_like(damp), damp)
    phi = phi * damp * w

    # multi-feature gate: the separability EMA updated first, then the
    # gate with THIS round's weights
    feats = new_sep = feat_w = None
    if feat_sep is not None:
        feats = trust_features_plain(g, r, gbar, med, w, ref_idx=ref_idx,
                                     eps=eps)
        new_sep = (feats_mod.FEAT_SEP_RHO * feat_sep
                   + (1.0 - feats_mod.FEAT_SEP_RHO)
                   * feats_mod.separability(feats, w, eps))
        feat_w = feats_mod.feature_weights(new_sep)
        phi = phi * feats_mod.gate(feats, new_sep)

    # Eq. 8–9: normalize over the round, EMA for delivered rows
    total = torch.sum(phi)
    rn = torch.where(total > eps, phi / torch.clamp(total, min=eps),
                     torch.full_like(phi, 1.0 / n))
    rep_old = rep_ema[sel_idx.long()]
    rep_sel = gamma * rep_old + (1.0 - gamma) * rn
    rep_sel = torch.where(w > 0, rep_sel, rep_old)
    # Eq. 11 trust
    ts = cos_ref * rep_sel * w
    return TrustStage(phi, ts, rep_sel, norms, med, gbar, feats, new_sep,
                      feat_w)


def _lib():
    fn = _build.load("trust_stage").trust_stage_launch
    if fn.argtypes is None:
        p, i, ll, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_float)
        fn.argtypes = [i, i, i, i, p, ll, p, ll, i, p, i, i, i, i,
                       p, p, p, p, p, ll, p, f, f, f, f,
                       p, p, p, p, p, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


def _as(t: Tensor, dtype: torch.dtype) -> Tensor:
    """``t`` as a contiguous ``dtype`` tensor (itself when it is one: the
    conversion calls cost a round's wrapper more than the checks)."""
    if t.dtype == dtype and t.is_contiguous():
        return t
    return t.to(dtype).contiguous()


def launch(mode: int, g: Tensor, ldg: int, ref: Tensor, ldr: int,
           ref_mode: int, n_ref: int, lo: int, length: int, m: int, outs,
           *, ref_idx=None, w=None, gbar_in=None, med_in=None, rep=None,
           sel_idx=None, n_rep=0, feat_sep=None, gamma=0.0, inv_n=0.0,
           eps=EPS) -> None:
    """One launch of ``csrc/trust_stage.cu`` (any mode) on the current
    stream. ``outs``: the device addresses of the fp32 outputs phi, ts,
    norms, rep_sel, med, gbar, feats, new_sep, feat_w and the scratch
    (None where the mode writes none). Raises on a launch the card
    refuses."""
    err = _lib()(
        mode, int(feat_sep is not None), DTYPES[g.dtype], DTYPES[ref.dtype],
        g.data_ptr(), ldg, ref.data_ptr(), ldr, ref_mode, _ptr(ref_idx),
        n_ref, lo, length, m, _ptr(w), _ptr(gbar_in), _ptr(med_in), _ptr(rep),
        _ptr(sel_idx), n_rep, _ptr(feat_sep), gamma, 1.0 - gamma, inv_n, eps,
        *outs, torch.cuda.current_stream(g.device).cuda_stream)
    _build.check(err, "trust_stage")


def trust_stage(flat: Tensor, refs: Tensor, lo: int, length: int,
                ref_idx: Tensor, w: Tensor, rep_ema: Tensor, sel_idx: Tensor,
                gamma: float, n: int, feat_sep: Optional[Tensor] = None,
                eps: float = EPS) -> TrustStage:
    """The stage over columns ``[lo, lo + length)`` of the wire ``flat``
    (m, D) and the own-cloud references ``refs`` (K, D) (row
    ``ref_idx[i]`` for row i), with delivery weights ``w``, the
    reputation EMA ``rep_ema`` (N,) of the ``sel_idx`` rows, EMA factor
    ``gamma`` over ``n`` clients, and with ``feat_sep`` the multi-feature
    gate. CPU tensors take :func:`trust_stage_plain`; CUDA tensors launch
    the kernel once (one 8-block cluster) or raise."""
    check_stage_inputs(flat, refs, lo, length, ref_idx, w, rep_ema, sel_idx,
                       feat_sep)
    if flat.device.type == "cpu":
        return trust_stage_plain(flat, refs, lo, length, ref_idx, w, rep_ema,
                                 sel_idx, gamma, n, feat_sep, eps)
    m, d = flat.shape
    multi = feat_sep is not None
    nf = feats_mod.N_FEATURES
    # one buffer: phi, ts, rep_sel, norms, med, gbar, the scratch, and
    # with multi the features, new_sep and feat_w
    sizes = [m, m, m, m, 1, length, STASH * m] + ([nf * m, nf, nf] if multi
                                                  else [])
    buf = torch.empty(sum(sizes), dtype=torch.float32, device=flat.device)
    at, off = [], buf.data_ptr()
    for size in sizes:
        at.append(off)
        off += 4 * size
    at += [None] * (10 - len(at))
    phi, ts, rep_sel, norms, med, gbar, work, feats, new_sep, feat_w = at
    f32, i64 = torch.float32, torch.int64
    launch(MODE_STAGE, flat, d, refs, d, REF_INDEXED, refs.shape[0], lo,
           length, m, (phi, ts, norms, rep_sel, med, gbar, feats, new_sep,
                       feat_w, work),
           ref_idx=_as(ref_idx, i64), w=_as(w, f32), rep=_as(rep_ema, f32),
           sel_idx=_as(sel_idx, i64), n_rep=rep_ema.shape[0],
           feat_sep=_as(feat_sep, f32) if multi else None, gamma=gamma,
           inv_n=1.0 / n, eps=eps)
    trust_stage.launches += 1
    parts = buf.split(sizes)
    return TrustStage(
        parts[0], parts[1], parts[2], parts[3], parts[4].view(()), parts[5],
        *((parts[7].view(m, nf), parts[8], parts[9]) if multi else ()))


trust_stage.launches = 0


def launch_floor(device: torch.device, cluster: bool) -> None:
    """One launch of the empty ``trust_stage_floor`` kernel on the
    stage's grid, plain or as one 8-block cluster (not counted)."""
    fn = _build.load("trust_stage").trust_stage_floor_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    _build.check(fn(int(cluster),
                    torch.cuda.current_stream(device).cuda_stream),
                 "trust_stage_floor")
