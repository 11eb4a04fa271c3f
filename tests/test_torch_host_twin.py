"""The port's host twin against the reference on identical numpy inputs:
the Eq. 8–9 and Eq. 11–13 helpers and the ``tree_*`` dot products
(within 1e-6 relative), the Shapley estimators and their utility (exactly
equal: both are numpy float64), the numpy Eq. 10 selection of the host
loop (masks equal, one ``default_rng`` each), and
``cost_trustfl_aggregate`` — the fused trust stage and segmented
``weighted_agg`` on the CPU's plain route — under ``scalar`` and
``multi``, with and without an edge wire, with a cloud that has no
selected client, with every trust zero and with no client selected
(update, trust, phi, beta, reputation, features and separability within
1e-5 relative).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import reputation as jrep
from repro.core import selection as jsel
from repro.core import shapley as jshap
from repro.core import trust as jtrust
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.core import (ReputationState, cost_trustfl_aggregate,
                              cosine_utility, ema_update, exact_shapley,
                              monte_carlo_shapley, normalize_scores,
                              normalize_updates, select_clients_host,
                              tree_cos, tree_dot, tree_norm, tree_scale,
                              trust_scores, trusted_aggregate)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _t(a):
    return torch.tensor(np.asarray(a))


# -- Eq. 8–9, Eq. 11–13 and the tree helpers ---------------------------------

def _pair(name: str):
    """(port result, reference result) of ``name`` on seeded inputs."""
    rng = np.random.default_rng(7)
    g = rng.standard_normal((9, 33)).astype(np.float32)
    ref = rng.standard_normal(33).astype(np.float32)
    rep = rng.random(9).astype(np.float32)
    phi = np.maximum(rng.standard_normal(9), 0).astype(np.float32)
    tree_a = {"w": rng.standard_normal((4, 5)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32),
              "h": rng.standard_normal(7).astype(np.float32)}
    tree_b = {k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in tree_a.items()}
    # a bf16 leaf: tree_dot upcasts it, tree_scale rounds back to it
    tree_a["h"] = np.asarray(jnp.asarray(tree_a["h"], jnp.bfloat16))
    jt = lambda t: {k: jnp.asarray(v) for k, v in t.items()}  # noqa: E731
    tt = lambda t: {k: torch.tensor(np.asarray(v, np.float32)).to(  # noqa: E731
        torch.bfloat16 if v.dtype != np.float32 else torch.float32)
        for k, v in t.items()}
    part = np.array([1, 0, 1, 1, 0, 1, 1, 1, 0], bool)
    cases = {
        "normalize_scores": (lambda: normalize_scores(_t(phi)),
                             lambda: jrep.normalize_scores(jnp.asarray(phi))),
        "normalize_scores_zero": (
            lambda: normalize_scores(torch.zeros(9)),
            lambda: jrep.normalize_scores(jnp.zeros(9))),
        "ema_update": (
            lambda: ema_update(ReputationState(_t(rep)), _t(phi), 0.9,
                               participated=_t(part)).ema,
            lambda: jrep.ema_update(jrep.ReputationState(jnp.asarray(rep)),
                                    jnp.asarray(phi), 0.9,
                                    participated=jnp.asarray(part)).ema),
        "trust_scores": (
            lambda: trust_scores(_t(g), _t(ref), _t(rep)),
            lambda: jtrust.trust_scores(jnp.asarray(g), jnp.asarray(ref),
                                        jnp.asarray(rep))),
        "normalize_updates": (
            lambda: normalize_updates(_t(g), _t(ref)),
            lambda: jtrust.normalize_updates(jnp.asarray(g),
                                             jnp.asarray(ref))),
        "trusted_aggregate": (
            lambda: trusted_aggregate(_t(g), _t(rep)),
            lambda: jtrust.trusted_aggregate(jnp.asarray(g),
                                             jnp.asarray(rep))),
        "tree_dot": (lambda: tree_dot(tt(tree_a), tt(tree_b)),
                     lambda: jtrust.tree_dot(jt(tree_a), jt(tree_b))),
        "tree_norm": (lambda: tree_norm(tt(tree_a)),
                      lambda: jtrust.tree_norm(jt(tree_a))),
        "tree_cos": (lambda: tree_cos(tt(tree_a), tt(tree_b)),
                     lambda: jtrust.tree_cos(jt(tree_a), jt(tree_b))),
        "tree_scale": (
            lambda: torch.cat([v.float().reshape(-1) for _, v in sorted(
                tree_scale(tt(tree_a), 0.37).items())]),
            lambda: jnp.concatenate([v.astype(jnp.float32).reshape(-1)
                                     for _, v in sorted(jtrust.tree_scale(
                                         jt(tree_a), 0.37).items())])),
    }
    got, want = cases[name]
    return got().float().numpy(), np.asarray(want(), np.float32)


@pytest.mark.parametrize("name", [
    "normalize_scores", "normalize_scores_zero", "ema_update",
    "trust_scores", "normalize_updates", "trusted_aggregate", "tree_dot",
    "tree_norm", "tree_cos", "tree_scale"])
def test_helpers_match_reference(name):
    got, want = _pair(name)
    assert got.shape == want.shape
    assert _rel(got, want) <= 1e-6, (name, _rel(got, want))


# -- Shapley estimators (numpy float64 on both sides) ------------------------

def _toy(n=8, d=24, seed=3):
    rng = np.random.default_rng(seed)
    ref = rng.normal(size=d)
    g = 0.8 * ref + 0.5 * rng.normal(size=(n, d))
    g[:2] = -g[:2]
    return g.astype(np.float32), ref.astype(np.float32)


@pytest.mark.parametrize("estimator", ["exact", "monte_carlo", "utility"])
def test_shapley_estimators_equal_reference(estimator):
    g, ref = _toy()
    util, jutil = cosine_utility(g, ref), jshap.cosine_utility(g, ref)
    if estimator == "exact":
        got, want = exact_shapley(util, 8), jshap.exact_shapley(jutil, 8)
    elif estimator == "monte_carlo":
        got = monte_carlo_shapley(util, 8, n_perms=50, seed=5)
        want = jshap.monte_carlo_shapley(jutil, 8, n_perms=50, seed=5)
    else:
        masks = np.random.default_rng(2).random((40, 8)) < 0.5
        masks[0] = False
        got = np.array([util(mk) for mk in masks])
        want = np.array([jutil(mk) for mk in masks])
    assert np.array_equal(got, want)
    with pytest.raises(ValueError, match="exponential"):
        exact_shapley(util, 17)


# -- Eq. 10 in numpy (the host loop's selection) -----------------------------

@pytest.mark.parametrize("quota", [0, 2])
@pytest.mark.parametrize("lam", [0.3, 1.0])
def test_select_clients_host_matches_reference(quota, lam):
    """Float32 reputations over float64 unit costs, a near-tie included;
    each side draws standard_normal(N) from its own default_rng(seed)."""
    cloud_of = np.repeat(np.arange(3), 5)
    costs = np.where(cloud_of == 0, 0.01, 0.04) + 0.03 / 5
    for seed in range(5):
        rep = np.random.default_rng(100 + seed).random(15).astype(np.float32)
        rep[3] = rep[4]
        got = select_clients_host(rep, costs, 6, per_cloud_min=quota,
                                  cloud_of=cloud_of, cost_lambda=lam,
                                  rng=np.random.default_rng(seed))
        want = jsel.select_clients(rep, costs, 6, per_cloud_min=quota,
                                   cloud_of=cloud_of, cost_lambda=lam,
                                   rng=np.random.default_rng(seed))
        assert np.array_equal(got, want), seed
        assert got.sum() == 6
    assert np.array_equal(
        select_clients_host(rep, costs, 4),
        jsel.select_clients(rep, costs, 4))


# -- cost_trustfl_aggregate ---------------------------------------------------

N, K, D, L = 12, 3, 96, 20


def _agg_inputs(case: str, seed: int = 0):
    """Updates (N, D) whose last layer is their final L columns, the rows'
    norms and alignments spread as honest and attacked updates differ
    (the separability divides by each feature's spread), zero rows where
    not selected — the host loop's scatter."""
    rng = np.random.default_rng(seed)
    cloud = np.repeat(np.arange(K), N // K)
    ref_dir = rng.standard_normal(D)
    refs = 0.95 * ref_dir + 0.2 * rng.standard_normal((K, D))
    align = rng.permutation(np.linspace(-0.6, 1.4, N))
    scale = rng.permutation(np.logspace(-0.5, 0.5, N))
    upd = scale[:, None] * (align[:, None] * refs[cloud]
                            + 0.5 * rng.standard_normal((N, D)))
    if case == "zero_trust":    # every row against its own-cloud reference
        upd = -np.abs(scale)[:, None] * (refs[cloud] + 0.05
                                         * rng.standard_normal((N, D)))
    sel = np.ones(N, bool)
    sel[[1, 6]] = False
    if case == "empty_cloud":
        sel[cloud == 2] = False
    if case == "none_selected":
        sel[:] = False
    upd = np.where(sel[:, None], upd, 0.0).astype(np.float32)
    refs = refs.astype(np.float32)
    rep = (0.02 + 0.1 * rng.random(N)).astype(np.float32)
    return upd, refs, cloud, sel, rep


@pytest.mark.parametrize("case", ["plain", "transform", "empty_cloud",
                                  "zero_trust", "none_selected"])
@pytest.mark.parametrize("features", ["scalar", "multi"])
def test_cost_trustfl_aggregate_matches_reference(case, features):
    upd, refs, cloud, sel, rep = _agg_inputs(case)
    sep0 = np.array([0.4, 1.0, 0.2, 0.7], np.float32)
    kw = dict(gamma=0.9, trust_features=features,
              feat_sep=sep0 if features == "multi" else None)

    def jtf(a):
        return a * 0.5 + 0.01

    def ttf(a):
        return a * 0.5 + 0.01
    want = jagg.cost_trustfl_aggregate(
        jnp.asarray(upd), jnp.asarray(upd[:, -L:]), jnp.asarray(refs),
        jnp.asarray(refs[:, -L:]), jnp.asarray(cloud), jnp.asarray(sel),
        jrep.ReputationState(jnp.asarray(rep)),
        cloud_transform=jtf if case == "transform" else None,
        **{**kw, "feat_sep": None if kw["feat_sep"] is None
           else jnp.asarray(kw["feat_sep"])})
    got = cost_trustfl_aggregate(
        _t(upd), _t(upd[:, -L:]), _t(refs), _t(refs[:, -L:]), _t(cloud),
        _t(sel), ReputationState(_t(rep)),
        cloud_transform=ttf if case == "transform" else None,
        **{**kw, "feat_sep": None if kw["feat_sep"] is None
           else _t(kw["feat_sep"])})

    pairs = dict(update=(got.update, want.update),
                 trust=(got.trust, want.trust), phi=(got.phi, want.phi),
                 beta=(got.beta, want.beta),
                 reputation=(got.reputation.ema, want.reputation.ema))
    if features == "multi":
        pairs.update(features=(got.features, want.features),
                     feat_sep=(got.feat_sep, want.feat_sep),
                     feat_weights=(got.feat_weights, want.feat_weights))
    else:
        assert got.features is got.feat_sep is got.feat_weights is None
    for name, (a, b) in pairs.items():
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, name
        assert _rel(a, b) <= 1e-5, (name, _rel(a, b))
    ts = got.trust.numpy()
    assert not ts[~sel].any() and not got.phi.numpy()[~sel].any()
    assert np.array_equal(got.reputation.ema.numpy()[~sel], rep[~sel])
    if case in ("zero_trust", "none_selected"):
        # every cloud falls back to its reference
        assert not ts.any()
        beta = np.asarray(want.beta)
        assert _rel(got.update.numpy(), beta @ refs) <= 1e-6
    if case == "empty_cloud":
        assert not ts[cloud == 2].any() and ts[cloud != 2].any()


def test_unknown_trust_features_raises():
    upd, refs, cloud, sel, rep = _agg_inputs("plain")
    with pytest.raises(ValueError, match="unknown trust_features"):
        cost_trustfl_aggregate(_t(upd), _t(upd[:, -L:]), _t(refs),
                               _t(refs[:, -L:]), _t(cloud), _t(sel),
                               ReputationState(_t(rep)),
                               trust_features="nope")
