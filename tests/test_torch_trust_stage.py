"""The fused trust stage (``repro_torch.kernels.trust_stage``) against the
reference engine's trust stage on identical inputs, and the kernel's
decomposition emulated in numpy against the plain version.

* The reference side restates the hierarchical branch of
  ``repro/federated/engine.py:round_step`` from the wire view to Eq. 11's
  trust (lines 718-752) with ``repro.core.features``,
  ``repro.core.shapley.gradient_contribution`` and ``jnp.nanmedian``; the
  port side calls ``trust_stage`` on the CPU (its plain version). Floats
  within 1e-5 (sums in another order). The sign-agreement counts behind
  f2 are equal: jnp.mean rounds count / L through another division than
  the port's IEEE one, so f2 itself may differ in its last bit.
* The emulation repeats, in numpy fp32, how ``csrc/trust_stage.cu``
  splits the work (8 column slices of an even width, a row's partial
  sums strided over 8 lanes and folded by a butterfly, the 8 slices'
  partials added
  in rank order, the rows' gbar summed in order, the median by rank
  counting) and holds it to ``trust_stage_plain``: gbar and f2 exactly,
  med within 1e-6 relative, the rest within 1e-5.

Most data spreads the rows' norms and their alignment with the
references evenly, as a round's honest and attacked updates differ: the
Pearson separability divides by each feature's spread over the delivered
rows, so where two or three delivered rows have nearly the same feature
(say reference cosines within 1e-2 of each other) a 1e-7 change in the
features moves it by more than 1e-5, and any two summation orders —
the reference's, the port's, the kernel's — disagree by that much.
One test draws norms and alignments at random instead and holds what
depends on the separability to that effect's bound, 1e-4.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import features as jfeatures
from repro.core.shapley import gradient_contribution as jgradient_contribution
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.configs.base import FLConfig
from repro_torch.federated import engine as tengine
from repro_torch.kernels import ops
from repro_torch.kernels import trust_stage as stage_mod

EPS = 1e-12
GAMMA = FLConfig().ema_gamma
N_CLIENTS = 40
W_CASES = ("ones", "rows_1_4_zero", "all_zero", "odd_delivered", "tied_norms")


def _inputs(m, d, lo, length, seed, case="ones", k=3, spread=True):
    """A wire (m, d) whose columns [lo, lo + length) hold the rows'
    last layers, own-cloud references (k, d), clouds, delivery weights,
    the reputation EMA and the selected ids, from ``seed``. ``spread``:
    the rows' norms and alignments evenly spread, in a random order;
    otherwise drawn uniformly over the same ranges."""
    rng = np.random.default_rng(seed)
    flat = rng.standard_normal((m, d)).astype(np.float32)
    refs = rng.standard_normal((k, d)).astype(np.float32)
    cloud = rng.integers(0, k, m)
    if spread:
        scale = np.geomspace(0.3, 3.0, m)[rng.permutation(m)]
        align = np.linspace(-0.5, 1.5, m)[rng.permutation(m)]
    else:
        scale = rng.uniform(0.3, 3.0, m)
        align = rng.uniform(-0.5, 1.5, m)
    ll = scale[:, None] * (align[:, None] * refs[cloud, lo:lo + length]
                           + rng.standard_normal((m, length)))
    flat[:, lo:lo + length] = ll.astype(np.float32)
    w = np.ones(m, np.float32)
    if case == "rows_1_4_zero":
        w[[i for i in (1, 4) if i < m]] = 0.0
    elif case == "all_zero":
        w[:] = 0.0
    elif case == "odd_delivered":
        w[:] = 0.0
        w[[i for i in (0, 2, 5) if i < m]] = 1.0
    elif case == "tied_norms":          # three equal norms, an even count
        flat[3, lo:lo + length] = -flat[2, lo:lo + length]
        flat[5, lo:lo + length] = flat[2, lo:lo + length]
        w[6:] = 0.0
    sel_idx = np.sort(rng.choice(N_CLIENTS, m, replace=False))
    rep_ema = rng.uniform(0.01, 0.2, N_CLIENTS).astype(np.float32)
    feat_sep = rng.uniform(0.0, 1.0, 4).astype(np.float32)
    return flat, refs, cloud, w, rep_ema, sel_idx, feat_sep


def _port(flat, refs, cloud, w, rep_ema, sel_idx, feat_sep, lo, length,
          multi):
    return ops.trust_stage(
        torch.tensor(flat), torch.tensor(refs), lo, length,
        torch.tensor(cloud), torch.tensor(w), torch.tensor(rep_ema),
        torch.tensor(sel_idx), GAMMA, N_CLIENTS,
        feat_sep=torch.tensor(feat_sep) if multi else None, eps=EPS)


def _reference(flat, refs, cloud, w, rep_ema, sel_idx, feat_sep, lo, length,
               multi):
    """repro/federated/engine.py:718-752 on the same inputs."""
    ll_sel = jnp.asarray(flat[:, lo:lo + length])
    ref_ll_sel = jnp.asarray(refs[:, lo:lo + length])[cloud]
    w = jnp.asarray(w)
    valid = w > 0
    rep = jnp.asarray(rep_ema)
    gbar = (w @ ll_sel) / jnp.maximum(jnp.sum(w), 1.0)
    norms = jnp.linalg.norm(ll_sel, axis=1)
    med = jnp.nanmedian(jnp.where(w > 0, norms, jnp.nan))
    damp = jnp.minimum(1.0, (med / jnp.maximum(norms, EPS)) ** 2)
    damp = jnp.where(jnp.isnan(damp), 1.0, damp)
    phi = jgradient_contribution(ll_sel, gbar) * damp * w
    out = dict(gbar=gbar, norms=norms, med=med)
    if multi:
        feats = jfeatures.client_features(ll_sel, ref_ll_sel, gbar, med, w,
                                          EPS)
        sep = jfeatures.separability(feats, w, EPS)
        new_sep = (jfeatures.FEAT_SEP_RHO * jnp.asarray(feat_sep)
                   + (1.0 - jfeatures.FEAT_SEP_RHO) * sep)
        out.update(feats=feats, new_sep=new_sep,
                   feat_w=jfeatures.feature_weights(new_sep))
        phi = phi * jfeatures.gate(feats, new_sep)
    total = jnp.sum(phi)
    r = jnp.where(total > EPS, phi / jnp.maximum(total, EPS),
                  1.0 / N_CLIENTS)
    rep_sel = GAMMA * rep[sel_idx] + (1.0 - GAMMA) * r
    rep_sel = jnp.where(valid, rep_sel, rep[sel_idx])
    dots = jnp.sum(ll_sel * ref_ll_sel, axis=1)
    cos = dots / jnp.maximum(norms * jnp.linalg.norm(ref_ll_sel, axis=1),
                             EPS)
    ts = jnp.maximum(cos, 0.0) * rep_sel * w
    out.update(phi=phi, rep_sel=rep_sel, ts=ts)
    return {k: np.asarray(v) for k, v in out.items()}


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", W_CASES)
@pytest.mark.parametrize("multi", [False, True], ids=["scalar", "multi"])
def test_trust_stage_matches_reference_engine(multi, case, seed):
    m, d, length = 7, 300, 40
    lo = d - length
    args = _inputs(m, d, lo, length, seed, case)
    got = _port(*args, lo, length, multi)
    want = _reference(*args, lo, length, multi)
    gbar = got.gbar.numpy()
    # no coordinate of gbar near 0 (its sign decides f2), unless no row
    # delivers and gbar is 0
    assert (np.abs(gbar) > 1e-6).all() or not gbar.any()
    for name in ("phi", "ts", "rep_sel", "norms", "gbar"):
        _close(getattr(got, name), want[name], 1e-5)
    if case == "all_zero":
        assert np.isnan(float(got.med)) and np.isnan(want["med"])
        np.testing.assert_array_equal(got.rep_sel.numpy(),
                                      args[4][args[5]])
    else:
        np.testing.assert_allclose(float(got.med), float(want["med"]),
                                   rtol=1e-6)
    if multi:
        for name in ("feats", "new_sep", "feat_w"):
            _close(getattr(got, name), want[name], 1e-5)
        np.testing.assert_array_equal(
            np.rint(got.feats[:, 2].numpy() * length),
            np.rint(want["feats"][:, 2] * length))
    else:
        assert got.feats is None and got.new_sep is None


def _separability_bound(feats, w):
    """(F,) what a one-ulp change in the features can move the fp32
    separability by: E[x^2] / var(x) of the feature and of the anchor
    (the one-pass variance's cancellation), times 4 ulp; from the
    reference's features in float64."""
    f = np.asarray(feats, np.float64)[w > 0]
    wv = np.asarray(w, np.float64)[w > 0][:, None]
    mean = (wv * f).sum(0) / wv.sum()
    sq = (wv * f * f).sum(0) / wv.sum()
    var = sq - mean * mean
    # a feature that is 0 in every delivered row: 0 on both sides
    kappa = np.divide(sq, var, out=np.where(sq > 0, np.inf, 0.0),
                      where=var > 0)
    kappa = np.maximum(kappa, kappa[jfeatures.ANCHOR_FEATURE])
    return 4 * np.finfo(np.float32).eps * kappa


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("case", ["rows_1_4_zero", "odd_delivered"])
def test_trust_stage_random_draws_match_reference(case, seed):
    """Norms and alignments drawn at random, not spread. Where delivered
    rows' features nearly coincide, the separability is ill-conditioned
    (ROADMAP.md C): its gap is held to what one ulp of the features
    gives through that conditioning, the half that new_sep takes of it,
    and the feature weights to the softmax's 1/T = 5 times that; the
    features, norms and gbar within 1e-5, med within 1e-6 relative."""
    m, d, length = 7, 300, 40
    lo = d - length
    args = _inputs(m, d, lo, length, seed, case, spread=False)
    got = _port(*args, lo, length, True)
    want = _reference(*args, lo, length, True)
    for name in ("norms", "gbar", "feats"):
        _close(getattr(got, name), want[name], 1e-5)
    np.testing.assert_allclose(float(got.med), float(want["med"]), rtol=1e-6)
    bound = 0.5 * _separability_bound(want["feats"], args[3]) + 1e-6
    gap = np.abs(got.new_sep.numpy() - want["new_sep"])
    assert (gap <= bound).all(), (gap, bound)
    gap_w = np.abs(got.feat_w.numpy() - want["feat_w"]).max()
    assert gap_w <= 5 * bound.max(), (gap_w, bound)


# ---------------------------------------------------------------------------
# the kernel's decomposition, emulated

def _lane_sum(v):
    """(lanes, ...) values folded as the xor butterfly folds them; every
    lane ends with the same value, lane 0's is returned."""
    v = v.copy()
    off = len(v) // 2
    while off:
        v = v + v[np.arange(len(v)) ^ off]
        off //= 2
    return v[0]


def _stage_np(flat, refs, cloud, w, rep_ema, sel_idx, feat_sep, lo, length,
              multi, blocks=stage_mod.CLUSTER):
    f32 = np.float32
    m = flat.shape[0]
    g = flat[:, lo:lo + length].astype(f32)
    r = refs[:, lo:lo + length].astype(f32)[cloud]
    per = -(-length // blocks)
    width = per + (per & 1)
    eps = f32(EPS)
    # gbar: rows in order, one product and one add each
    acc = np.zeros(length, f32)
    sw = f32(0)
    for i in range(m):
        acc = acc + w[i] * g[i]
        sw = f32(sw + w[i])
    gbar = acc / max(sw, f32(1))
    # per slice: a row's partials (and |gbar|^2) strided over 8 lanes and
    # folded by a butterfly; slices added in rank order
    stats = np.zeros((m, 5), f32)
    bb = f32(0)
    for rank in range(blocks):
        c0, c1 = rank * width, min(length, (rank + 1) * width)
        lanes = np.zeros((8, m, 5), f32)
        lanes_bb = np.zeros(8, f32)
        for j in range(c0, c1):
            x, b, rr = g[:, j], gbar[j], r[:, j]
            ln = (j - c0) % 8
            lanes[ln, :, 0] += x * b
            lanes[ln, :, 1] += x * rr
            lanes[ln, :, 2] += x * x
            lanes[ln, :, 3] += rr * rr
            lanes[ln, :, 4] += (x * b > 0).astype(f32)
            lanes_bb[ln] += b * b
        stats = stats + _lane_sum(lanes)
        bb = f32(bb + _lane_sum(lanes_bb))
    norm = np.sqrt(np.maximum(stats[:, 2], 0)).astype(f32)
    nref = np.sqrt(np.maximum(stats[:, 3], 0)).astype(f32)
    nbar = f32(np.sqrt(max(bb, f32(0))))
    cos_ref = np.maximum(stats[:, 1] / np.maximum(norm * nref, eps), 0)
    phi = np.maximum(stats[:, 0] / np.maximum(norm * nbar, eps), 0) * norm
    # the median by rank counting over the delivered norms
    valid = w > 0
    vals = norm[valid]
    n_valid = len(vals)
    pick = {}
    for x in vals:
        less, eq = int((vals < x).sum()), int((vals == x).sum())
        for kth in ((n_valid - 1) // 2, n_valid // 2):
            if less <= kth < less + eq:
                pick[kth] = x
    if n_valid == 0:
        med = f32(np.nan)
    elif n_valid % 2:
        med = pick[(n_valid - 1) // 2]
    else:
        lo_v, hi_v = pick[(n_valid - 1) // 2], pick[n_valid // 2]
        med = f32(hi_v - f32(f32(hi_v - lo_v) * f32(0.5)))
    with np.errstate(invalid="ignore"):
        q = med / np.maximum(norm, eps)
        damp = np.where(np.isnan(q * q), f32(1), np.minimum(q * q, f32(1)))
    phi = (phi * damp * w).astype(f32)
    out = dict(gbar=gbar, norms=norm, med=med)
    if multi:
        med_f = f32(1) if (np.isnan(med) or not med > 0) else med
        f0 = 1 / (1 + np.abs(np.log(np.maximum(norm, eps) / med_f)))
        f2 = stats[:, 4] / f32(length)
        ratio = np.maximum(norm, eps) / med_f
        x = cos_ref * np.minimum(ratio, 1 / ratio)
        feats = (np.stack([f0, cos_ref, f2, x / (1 + x)], 1)
                 * w[:, None]).astype(f32)
        a = feats[:, 1:2]
        wv = w[:, None]
        sums = np.stack([np.broadcast_to(wv, feats.shape).sum(0),
                         (wv * feats).sum(0), (wv * a * np.ones_like(feats)
                                               ).sum(0),
                         (wv * feats * feats).sum(0),
                         (wv * a * a * np.ones_like(feats)).sum(0),
                         (wv * feats * a).sum(0)]).astype(f32)
        sw_ = np.maximum(sums[0], eps)
        mf, mr = sums[1] / sw_, sums[2] / sw_
        vf = np.maximum(sums[3] / sw_ - mf * mf, 0)
        vr = np.maximum(sums[4] / sw_ - mr * mr, 0)
        cov = sums[5] / sw_ - mf * mr
        corr = cov / np.sqrt(np.maximum(vf * vr, eps * eps))
        corr = np.where((vf > eps) & (vr > eps), corr, 0)
        new_sep = (f32(0.5) * feat_sep + f32(0.5) * np.clip(corr, 0, 1)
                   ).astype(f32)
        e = np.exp(new_sep / f32(0.2) - (new_sep / f32(0.2)).max())
        fw = (e / e.sum()).astype(f32)
        beta = f32(0.3) * np.clip(new_sep[0], 0, 1)
        phi = (phi * ((1 - beta) + beta * (feats @ fw))).astype(f32)
        out.update(feats=feats, new_sep=new_sep, feat_w=fw)
    total = phi.sum(dtype=f32)
    rn = phi / max(total, eps) if total > eps else np.full(m, 1 / N_CLIENTS)
    old = rep_ema[sel_idx]
    rep_sel = np.where(valid, f32(GAMMA) * old + f32(1 - GAMMA) * rn, old)
    out.update(phi=phi, rep_sel=rep_sel, ts=cos_ref * rep_sel * w)
    return out


@pytest.mark.parametrize("parity", ["even", "odd"])
@pytest.mark.parametrize("m", [1, 2, 7, 30, 33])
@pytest.mark.parametrize("length", [1, 10, 1290, 1291])
def test_trust_stage_decomposition_matches_plain(length, m, parity):
    d = length + 7
    lo = 6 if parity == "even" else 5
    args = _inputs(m, d, lo, length, seed=length + m,
                   case="rows_1_4_zero" if m > 4 else "ones")
    for multi in (False, True):
        emu = _stage_np(*args, lo, length, multi)
        got = _port(*args, lo, length, multi)
        np.testing.assert_array_equal(got.gbar.numpy(), emu["gbar"])
        np.testing.assert_allclose(float(got.med), float(emu["med"]),
                                   rtol=1e-6)
        for name in ("phi", "ts", "rep_sel", "norms"):
            _close(getattr(got, name), emu[name], 1e-5)
        if multi:
            np.testing.assert_array_equal(got.feats[:, 2].numpy(),
                                          emu["feats"][:, 2])
            for name in ("feats", "new_sep", "feat_w"):
                _close(getattr(got, name), emu[name], 1e-5)


def test_trust_stage_degenerate_rounds():
    """No delivered row: med NaN, damp and the features' med 1,
    separability 0 (zero weight), r = 1/n on no row (w = 0 keeps the old
    reputation); every phi 0: total <= eps, r = 1/n for delivered rows."""
    m, d, length = 6, 50, 20
    lo = d - length
    flat, refs, cloud, w, rep_ema, sel_idx, feat_sep = _inputs(
        m, d, lo, length, 3)
    out = _port(flat, refs, cloud, np.zeros(m, np.float32), rep_ema,
                sel_idx, feat_sep, lo, length, True)
    assert np.isnan(float(out.med))
    assert not out.phi.any() and not out.ts.any() and not out.feats.any()
    np.testing.assert_allclose(out.new_sep.numpy(), 0.5 * feat_sep,
                               rtol=1e-6)
    np.testing.assert_array_equal(out.rep_sel.numpy(), rep_ema[sel_idx])
    # rows orthogonal to the delivered mean: phi = 0, so r = 1/n
    flat[:, lo:] = 0.0
    flat[0, lo] = 1.0
    flat[1, lo] = -1.0
    out = _port(flat, refs, cloud, np.ones(m, np.float32), rep_ema, sel_idx,
                feat_sep, lo, length, False)
    assert not out.phi.any()
    np.testing.assert_allclose(
        out.rep_sel.numpy(),
        GAMMA * rep_ema[sel_idx] + (1 - GAMMA) / N_CLIENTS, rtol=1e-6)


def test_trust_stage_cpu_is_plain_and_counts_no_launch():
    args = _inputs(7, 300, 260, 40, 0)
    before = ops.trust_stage.launches
    got = _port(*args, 260, 40, True)
    want = stage_mod.trust_stage_plain(
        *(torch.tensor(a) for a in args[:2]), 260, 40,
        *(torch.tensor(a) for a in args[2:6]), GAMMA, N_CLIENTS,
        feat_sep=torch.tensor(args[6]), eps=EPS)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert ops.trust_stage.launches == before


# ---------------------------------------------------------------------------
# what the kernel does not take

def _refused(case):
    m, d, length = 5, 60, 20
    flat, refs, cloud, w, rep_ema, sel_idx, feat_sep = (
        torch.tensor(a) for a in _inputs(m, d, d - length, length, 0))
    lo = d - length
    if case == "bf16_wire":
        flat = flat.to(torch.bfloat16)
    elif case == "range_past_d":
        lo += 1
    elif case == "refs_other_width":
        refs = refs[:, :-1].contiguous()
    elif case == "cloud_index_out_of_range":
        cloud = cloud.clone()
        cloud[2] = 3
    elif case == "too_many_refs":
        refs = torch.zeros(9, d)
    elif case == "mismatched_m":
        w = w[:-1]
    elif case == "selected_index_out_of_range":
        sel_idx = sel_idx.clone()
        sel_idx[0] = N_CLIENTS
    elif case == "non_contiguous_wire":
        flat = torch.cat([flat, flat], 1)[:, ::2]
    return (flat, refs, lo, length, cloud, w, rep_ema, sel_idx, feat_sep)


@pytest.mark.parametrize("case", [
    "bf16_wire", "range_past_d", "refs_other_width",
    "cloud_index_out_of_range", "too_many_refs", "mismatched_m",
    "selected_index_out_of_range", "non_contiguous_wire"])
def test_trust_stage_refuses_what_the_kernel_does_not_take(case):
    flat, refs, lo, length, cloud, w, rep_ema, sel_idx, feat_sep = _refused(
        case)
    with pytest.raises(ValueError):
        stage_mod.check_stage_inputs(flat, refs, lo, length, cloud, w,
                                     rep_ema, sel_idx, feat_sep)
    with pytest.raises(ValueError):
        ops.trust_stage(flat, refs, lo, length, cloud, w, rep_ema, sel_idx,
                        GAMMA, N_CLIENTS, feat_sep=feat_sep)


# ---------------------------------------------------------------------------
# the engine's side

def _paper_shapes():
    eng = tengine.Engine(tengine.static_from(FLConfig(), _topology()),
                         torch.device("cpu"))
    return eng, eng.shapes, eng.d_params


def _topology():
    from repro_torch.federated.simulation import make_topology
    return make_topology(FLConfig(n_clouds=3, clients_per_cloud=2,
                                  clients_per_round=3))


def test_paper_cnn_last_layer_is_one_contiguous_range():
    eng, shapes, d = _paper_shapes()
    assert d == 545_098
    idx = tengine.last_layer_index(shapes)
    np.testing.assert_array_equal(np.sort(idx), np.arange(d - 1290, d))
    assert tengine.last_layer_range(shapes) == (d - 1290, 1290)
    assert (eng.ll_lo, eng.ll_len) == (d - 1290, 1290)


def test_engine_raises_on_a_non_contiguous_last_layer(monkeypatch):
    """fc1_w and fc2_b lie between fc1_b and fc2_w in the flattened
    vector: no single range holds both leaves."""
    _, shapes, _ = _paper_shapes()
    monkeypatch.setattr(tengine, "LAST_LAYER", ("fc2_w", "fc1_b"))
    with pytest.raises(ValueError, match="contiguous"):
        tengine.last_layer_range(shapes)
    with pytest.raises(ValueError, match="contiguous"):
        _paper_shapes()


@pytest.mark.parametrize("features", ["scalar", "multi"])
def test_engine_runs_the_stage_once_a_round(monkeypatch, features):
    """One round calls ``trust_stage`` once and neither standalone
    wrapper; its outputs feed the state (the reputation scatter, the
    separability EMA, the feature weights)."""
    from repro_torch.federated.simulation import make_data, make_topology
    fl = FLConfig(n_clouds=2, clients_per_cloud=3, clients_per_round=4,
                  local_epochs=1, local_batch=8, ref_samples=16,
                  trust_features=features)
    topo = make_topology(fl)
    data = make_data(fl, n_samples=200, samples_per_client=8)
    cpu = torch.device("cpu")
    eng = tengine.Engine(tengine.static_from(fl, topo), cpu)
    cd = tengine.make_client_data(fl, topo, data, 0, device=cpu)
    state = eng.init_state(0)
    calls = {"trust_stage": [], "trust_score": 0, "trust_features": 0}
    real = ops.trust_stage

    def spy(*a, **kw):
        out = real(*a, **kw)
        calls["trust_stage"].append(out)
        return out

    def refuse(name):
        def fn(*a, **kw):
            calls[name] += 1
            raise AssertionError(f"the engine called {name}")
        return fn

    monkeypatch.setattr(ops, "trust_stage", spy)
    monkeypatch.setattr(ops, "trust_score", refuse("trust_score"))
    monkeypatch.setattr(ops, "trust_features", refuse("trust_features"))
    new, out = eng.step(state, cd, 0)
    assert len(calls["trust_stage"]) == 1
    assert calls["trust_score"] == calls["trust_features"] == 0
    st = calls["trust_stage"][0]
    sel = torch.nonzero(out.delivered).reshape(-1)
    assert torch.equal(new.rep_ema[sel], st.rep_sel)
    if features == "multi":
        assert torch.equal(new.feat_sep, st.new_sep)
        assert torch.equal(out.feat_weights, st.feat_w)
        assert abs(float(st.feat_w.sum()) - 1.0) < 1e-6
    else:
        assert new.feat_sep.numel() == 0 and out.feat_weights.numel() == 0
