"""The port's multi-feature defense path against the reference on
identical inputs: the update attacks, the multi-feature helpers, the QSGD
codec, and three chained replayed rounds of ``Engine.step`` against
``CompiledEngine.step`` under

    attack="alie_norm", malicious_frac=0.3, trust_features="multi",
    compressor="qsgd", qsgd_levels=15, link_policy="all"

at the suite's small topology (3 clouds x 4 clients, 6 selected; the
CNN at full width, D = 545,098), plus a CPU ``run_simulation`` smoke run.

Tolerances: attacks and features 1e-5 (fp32 sums in another order);
QSGD payloads, levels, round trips and EF steps exact; masks, bytes and
$ exact; reputation, params, feature separability and weights within
1e-4 relative; residuals within 1e-4 off the QSGD level flips (see
``test_three_defense_rounds_match_reference``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_replay import flat, reference_draws, rel
from repro.compress import ef_step_masked as jef_step_masked
from repro.compress.qsgd import QSGDCodec as JQSGDCodec
from repro.configs.base import FLConfig as JFLConfig
from repro.core import attacks as jattacks
from repro.core import features as jfeatures
from repro.federated import engine as jengine
from repro.federated.simulation import make_data as jmake_data
from repro.federated.simulation import make_topology as jmake_topology
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch import convert
from repro_torch.compress import QSGDCodec, ef_step, ef_step_masked
from repro_torch.configs.base import FLConfig
from repro_torch.core import attacks, features
from repro_torch.federated import engine as tengine
from repro_torch.federated.simulation import (make_data, make_topology,
                                              run_simulation)
from repro_torch.kernels import ops

CPU = torch.device("cpu")
DEFENSE = dict(attack="alie_norm", malicious_frac=0.3,
               trust_features="multi", compressor="qsgd", qsgd_levels=15,
               link_policy="all")
_FL = dict(n_clouds=3, clients_per_cloud=4, clients_per_round=6,
           local_epochs=1, local_batch=8, ref_samples=16, **DEFENSE)
_DATA = dict(n_samples=600, samples_per_client=16)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# -- update attacks ----------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["gaussian", "sign_flip", "scaling", "alie",
                                  "alie_norm", "ipm", "min_max",
                                  "collusion"])
def test_update_attack_matches_reference(name, masked):
    rng = np.random.default_rng(len(name) + 10 * masked)
    m, d = 9, 257
    u = (rng.standard_normal((m, d)) * 1e-2).astype(np.float32)
    mal = np.zeros(m, bool)
    mal[[1, 4, 6]] = True
    valid = rng.random(m) < 0.7 if masked else None
    key = jax.random.PRNGKey(5)
    kw = dict(sigma=0.5, scale=3.0, z=1.5)
    want = jattacks.apply_update_attack(
        name, jnp.asarray(u), jnp.asarray(mal), key, **kw,
        valid=None if valid is None else jnp.asarray(valid))
    # gaussian: the reference's own normals, injected
    normals = torch.tensor(np.asarray(jax.random.normal(key, (m, d))))
    got = attacks.apply_update_attack(
        name, torch.tensor(u), torch.tensor(mal), normals, **kw,
        valid=None if valid is None else torch.tensor(valid))
    _close(got, want)
    assert np.array_equal(got[~mal].numpy(), u[~mal])


def test_unknown_or_noiseless_attack_raises():
    u, mal = torch.zeros(2, 3), torch.tensor([True, False])
    with pytest.raises(ValueError, match="unknown attack"):
        attacks.apply_update_attack("nope", u, mal)
    with pytest.raises(ValueError, match="normals"):
        attacks.apply_update_attack("gaussian", u, mal)
    assert attacks.apply_update_attack("label_flip", u, mal) is u


# -- multi-feature helpers ---------------------------------------------------

def _feature_case(case: str):
    rng = np.random.default_rng(3)
    m, L = 8, 40
    g = rng.standard_normal((m, L)).astype(np.float32)
    refs = rng.standard_normal((m, L)).astype(np.float32)
    w = (rng.random(m) < 0.75).astype(np.float32)
    if case == "no_delivery":
        w[:] = 0.0
    gbar = (w @ g) / max(w.sum(), 1.0)
    norms = np.linalg.norm(g, axis=1)
    med = np.nanmedian(np.where(w > 0, norms, np.nan)) if w.any() \
        else np.float32(np.nan)
    return g, refs, gbar.astype(np.float32), np.float32(med), w


@pytest.mark.parametrize("case", ["random", "zero_variance", "no_delivery"])
def test_feature_helpers_match_reference(case):
    if case == "zero_variance":
        # identical rows of dyadic values: every sum and variance exact
        w = np.ones(8, np.float32)
        jf = jnp.tile(jnp.asarray([[0.5, 0.75, 0.25, 0.125]]), (8, 1))
        tf = torch.tensor(np.asarray(jf))
    else:
        g, refs, gbar, med, w = _feature_case(case)
        jf = jfeatures.client_features(jnp.asarray(g), jnp.asarray(refs),
                                       jnp.asarray(gbar), jnp.asarray(med),
                                       jnp.asarray(w))
        tf = features.client_features(torch.tensor(g), torch.tensor(refs),
                                      torch.tensor(gbar), torch.tensor(med),
                                      torch.tensor(w))
        _close(tf, jf)
    sums = features.separability_sums(tf, torch.tensor(w))
    _close(sums, jfeatures.separability_sums(jf, jnp.asarray(w)))
    sep = features.separability_from_sums(sums)
    _close(sep, jfeatures.separability_from_sums(
        jfeatures.separability_sums(jf, jnp.asarray(w))))
    _close(features.separability(tf, torch.tensor(w)),
           jfeatures.separability(jf, jnp.asarray(w)))
    if case != "random":
        assert not sep.any()          # no evidence this round
    ema = torch.tensor([0.7, 1.0, 0.2, 0.0]) * (case == "random")
    jema = jnp.asarray(ema.numpy())
    _close(features.feature_weights(ema), jfeatures.feature_weights(jema))
    _close(features.gate_strength(ema), jfeatures.gate_strength(jema))
    _close(features.gate(tf, ema), jfeatures.gate(jf, jema))
    if case != "random":              # zero evidence: the gate is 1
        assert torch.equal(features.gate(tf, ema), torch.ones(len(w)))


# -- QSGD --------------------------------------------------------------------

@pytest.mark.parametrize("levels", [1, 15, 127])
@pytest.mark.parametrize("d", [1, 7, 545_098])
def test_qsgd_payload_bytes_exact(d, levels):
    codec, jcodec = QSGDCodec(levels), JQSGDCodec(levels)
    assert codec.bits_per_coord == jcodec.bits_per_coord
    assert codec.payload_bytes(d) == jcodec.payload_bytes(d)
    if (d, levels) == (545_098, 15):
        assert codec.payload_bytes(d) == 340_691


@pytest.mark.parametrize("d,levels", [(50, 1), (1000, 15), (545, 127)])
def test_qsgd_roundtrip_and_ef_step_exact(d, levels):
    """The codec fed the reference's per-sender ``fold_in`` noise equals
    the reference codec exactly, rows in any order."""
    rng = np.random.default_rng(d)
    x = (rng.standard_normal((4, d)) * 1e-3).astype(np.float32)
    x[2] = 0.0                                   # a zero row: q = 0
    res = (rng.standard_normal((4, d)) * 1e-4).astype(np.float32)
    ids = np.array([7, 0, 11, 3])
    mask = np.array([True, False, True, True])
    key = jax.random.PRNGKey(d)
    noise = torch.tensor(np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(key, int(i)), (d,))) for i in ids]))
    codec, jcodec = QSGDCodec(levels), JQSGDCodec(levels)
    want = jcodec.roundtrip(jnp.asarray(x), key, jnp.asarray(ids))
    got = codec.roundtrip(torch.tensor(x), noise)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert not got[2].any()
    got = ef_step_masked(codec, torch.tensor(x), torch.tensor(res),
                         torch.tensor(mask), noise)
    want = jef_step_masked(jcodec, jnp.asarray(x), jnp.asarray(res),
                           jnp.asarray(mask), key, jnp.asarray(ids))
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    x_hat, new_res = ef_step(codec, torch.tensor(x), torch.tensor(res),
                             noise)
    assert torch.equal(x_hat[mask], got[0][torch.tensor(mask)])
    y = torch.tensor(x) + torch.tensor(res)
    assert torch.equal(new_res, y - x_hat)


# -- three replayed DEFENSE rounds -------------------------------------------

def _levels(y: np.ndarray, noise: np.ndarray, levels: int) -> np.ndarray:
    yt = torch.tensor(y)
    return ops.stochastic_quantize(
        yt, torch.amax(yt.abs(), dim=1), torch.tensor(noise),
        levels=levels).numpy()


def test_three_defense_rounds_match_reference(monkeypatch):
    """Three chained rounds from the same initial state, replaying the
    reference's draws (selection, minibatches, and the QSGD noise of
    every sender on both wires).

    Wire caveat: float32 sums taken in another order move the pre-QSGD
    uplink y by ~1e-6 relative. An entry whose |v| + u lies within that
    of an integer takes the other level in one run — a level flip, which
    moves that entry of x̂ and of the EF residual by scale/L, and through
    the aggregate the same coordinate of the edge uplink and of the
    params. The test shows this is the only source of residual drift:
    fed the reference's own y and noise, the port's QSGD round trip
    equals the reference's exactly; both residuals agree within 1e-4 off
    the coordinates (columns) where either wire has flipped a level so
    far; flips are bounded (≤ 1e-4 of a wire's entries per round) and
    printed. Measured: 1 / 1 / 9 client-wire and 0 / 6 / 27 edge-wire
    flips in rounds 0-2, residuals off them within 5e-5 / 8.3e-5
    (client / edge, round 2), 1.4e-2 in all (each flip moves a residual
    entry by a full level); reputation 1e-6, params 2e-5."""
    captured_j, captured_t = [], []
    orig_j = JQSGDCodec.roundtrip
    orig_t = QSGDCodec.roundtrip_residual

    def spy_j(self, x, key, row_ids=None):
        jax.debug.callback(lambda v: captured_j.append(np.asarray(v)), x)
        return orig_j(self, x, key, row_ids)

    def spy_t(self, y, noise=None):
        captured_t.append(y.clone())
        return orig_t(self, y, noise)

    monkeypatch.setattr(JQSGDCodec, "roundtrip", spy_j)
    monkeypatch.setattr(QSGDCodec, "roundtrip_residual", spy_t)

    jfl, tfl = JFLConfig(**_FL), FLConfig(**_FL)
    topo = jmake_topology(jfl)
    # a private build (not the lru-cached one) so the spy is traced in
    eng = jengine._compiled.__wrapped__(
        jengine.static_from(jfl, topo, "cost_trustfl"), None)
    jcd = jengine.make_client_data(jfl, topo, jmake_data(
        jfl, "cifar10", seed=0, **_DATA), 0)
    jstate = eng.init_state(0)

    ttopo = make_topology(tfl)
    teng = tengine.Engine(tengine.static_from(tfl, ttopo), CPU)
    tcd = tengine.make_client_data(tfl, ttopo, make_data(tfl, **_DATA), 0,
                                   device=CPU)
    tstate = convert.round_state_from_numpy(
        {k: np.asarray(v) for k, v in jstate.params.items()},
        np.asarray(jstate.rep_ema), np.asarray(jstate.res_edge), 0,
        device=CPU, res_client=np.asarray(jstate.res_client),
        feat_sep=np.asarray(jstate.feat_sep))
    assert tstate.res_client.shape == (topo.n_clients, teng.d_params)
    steps, ref_steps = teng.schedule(tcd)
    n, k, d = topo.n_clients, topo.n_clouds, teng.d_params
    levels = jfl.qsgd_levels
    flipped = np.zeros(d, bool)

    for t in range(3):
        captured_j.clear()
        captured_t.clear()
        jstate, jout = eng.step(jstate, jcd, t)
        jax.block_until_ready(jstate)
        jax.effects_barrier()
        draws = reference_draws(0, t, n, steps, jfl.local_batch,
                                _DATA["samples_per_client"], ref_steps,
                                jfl.ref_samples, d=d, k=k)
        tstate, tout = teng.step(tstate, tcd, t, draws)

        delivered = np.asarray(jout.delivered)
        assert np.array_equal(tout.delivered.numpy(), delivered)
        assert np.array_equal(
            teng.host_round_accounting(delivered[None]),
            eng.host_round_accounting(delivered[None], t0=t))
        drift = dict(
            rep=rel(tstate.rep_ema.numpy(), jstate.rep_ema),
            params=rel(flat(tstate.params), flat(jstate.params)),
            feat_sep=rel(tstate.feat_sep.numpy(), jstate.feat_sep),
            feat_weights=rel(tout.feat_weights.numpy(), jout.feat_weights))
        assert max(drift.values()) <= 1e-4, drift

        # one client-wire and one edge-wire round trip per round, each
        # exact on the reference's own input and noise
        sel_idx = np.nonzero(delivered)[0]
        (yj_c,), (yj_e,) = ([y for y in captured_j if y.shape[0] == r]
                            for r in (len(sel_idx), k))
        yt_c, yt_e = (y.numpy() for y in captured_t)
        key = jengine.round_key(jnp.int32(0), jnp.int32(t))
        ckey = jax.random.fold_in(key, 211)
        ekey = jax.random.fold_in(jax.random.fold_in(key, 223), 3)
        wires = {"client": (yj_c, yt_c, draws.client_noise[sel_idx].numpy(),
                            ckey, jnp.asarray(sel_idx), sel_idx),
                 "edge": (yj_e, yt_e, draws.edge_noise.numpy(), ekey, None,
                          np.arange(k))}
        flips = {}
        for wire, (yj, yt, noise, wkey, ids, rows) in wires.items():
            want = orig_j(JQSGDCodec(levels), jnp.asarray(yj), wkey, ids)
            got = QSGDCodec(levels).roundtrip(torch.tensor(yj),
                                              torch.tensor(noise))
            assert np.array_equal(got.numpy(), np.asarray(want)), wire
            flip = _levels(yj, noise, levels) != _levels(yt, noise, levels)
            assert flip.sum() <= 1e-4 * flip.size, (wire, int(flip.sum()))
            flipped |= flip.any(axis=0)
            flips[wire] = int(flip.sum())

        res = {"client": (tstate.res_client.numpy(),
                          np.asarray(jstate.res_client)),
               "edge": (tstate.res_edge.numpy(), np.asarray(jstate.res_edge))}
        off = {w: rel(a[:, ~flipped], b[:, ~flipped])
               for w, (a, b) in res.items()}
        total = {w: rel(a, b) for w, (a, b) in res.items()}
        print(f"round {t}: " + " ".join(f"{a} {v:.2e}"
                                         for a, v in drift.items())
              + f"; QSGD level flips {flips}; residuals off the flips "
              f"{off}, in all {total}")
        assert max(off.values()) <= 1e-4, off
        assert max(total.values()) <= 5e-2, total


def test_own_mode_wire_noise_is_per_sender():
    """A client's own-mode noise depends on who sent the row, never on
    its position; ``full_noise`` draws the same streams up front."""
    fl = FLConfig(**_FL)
    topo = make_topology(fl)
    eng = tengine.Engine(tengine.static_from(fl, topo), CPU)
    a = eng.client_noise(0, 2, [5, 1, 9])
    b = eng.client_noise(0, 2, [9, 5])
    assert torch.equal(a[0], b[1]) and torch.equal(a[2], b[0])
    assert not torch.equal(a[0], eng.client_noise(0, 3, [5])[0])
    cd = tengine.make_client_data(fl, topo, make_data(fl, **_DATA), 0,
                                  device=CPU)
    full = eng.draws(0, 2, cd, full_noise=True)
    assert torch.equal(full.client_noise[[5, 1, 9]], a)
    assert torch.equal(full.edge_noise, eng.edge_noise(0, 2))
    assert full.edge_noise.shape == (topo.n_clouds, eng.d_params)
    assert float(full.client_noise.min()) >= 0.0
    assert float(full.client_noise.max()) < 1.0


def test_defense_run_simulation_cpu_smoke():
    fl = FLConfig(**_FL)
    r = run_simulation(fl, rounds=2, eval_every=1, device="cpu",
                       data=make_data(fl, **_DATA))
    assert r.rounds == [1, 2] and 0.0 <= r.final_accuracy <= 1.0
    assert np.all(np.isfinite(r.reputation))
    # QSGD on every client and edge uplink: 4 + ceil(5 D / 8) bytes each
    d, payload = 545_098, 340_691
    assert QSGDCodec(15).payload_bytes(d) == payload
    topo = make_topology(fl)
    per_round_edges = topo.n_clouds * payload
    assert r.intra_bytes + r.cross_bytes == 2 * (
        fl.clients_per_round * payload + per_round_edges)


def test_defense_server_reports_feature_weights():
    from repro_torch.federated import FLServer
    fl = FLConfig(**_FL)
    topo = make_topology(fl)
    server = FLServer(fl, topo, make_data(fl, **_DATA), device="cpu")
    met = server.run_round(0)
    fw = met.extra["feat_weights"]
    assert fw.shape == (features.N_FEATURES,) and np.all(np.isfinite(fw))
    assert abs(float(fw.sum()) - 1.0) <= 1e-6
    st = server._eng_state
    assert torch.isfinite(st.res_client).all()
    assert torch.isfinite(st.res_edge).all()
    assert st.feat_sep.shape == (features.N_FEATURES,)


@pytest.mark.parametrize("override", [
    dict(attack="gaussian", link_policy="intra_only"),
    dict(attack="collusion", link_policy="cross_only",
         trust_features="scalar")])
def test_two_rounds_other_wires_match_reference(override):
    """Two replayed rounds of two more wirings: QSGD on the intra-class
    links only (the edge wire reads the intra codec's sub-fold 2) under
    the gaussian attack (its normals replayed), and QSGD on the
    cross-cloud edge uplinks only (no client wire) under collusion with
    the scalar Eq. 7 score. Masks, bytes and $ exact;
    reputation, params and feature separability within 1e-4; residuals
    within 1e-4 off the few entries (≤ 0.1% of them) that one run's wire
    rounds differently — QSGD level flips, which
    ``test_three_defense_rounds_match_reference`` isolates by its
    inputs."""
    cfg = {**_FL, **override}
    jfl, tfl = JFLConfig(**cfg), FLConfig(**cfg)
    topo = jmake_topology(jfl)
    eng = jengine.compiled(jengine.static_from(jfl, topo, "cost_trustfl"))
    jcd = jengine.make_client_data(jfl, topo, jmake_data(
        jfl, "cifar10", seed=0, **_DATA), 0)
    jstate = eng.init_state(0)
    teng = tengine.Engine(tengine.static_from(tfl, make_topology(tfl)), CPU)
    tcd = tengine.make_client_data(tfl, make_topology(tfl),
                                   make_data(tfl, **_DATA), 0, device=CPU)
    tstate = convert.round_state_from_numpy(
        {k: np.asarray(v) for k, v in jstate.params.items()},
        np.asarray(jstate.rep_ema), np.asarray(jstate.res_edge), 0,
        device=CPU, res_client=np.asarray(jstate.res_client),
        feat_sep=np.asarray(jstate.feat_sep))
    steps, ref_steps = teng.schedule(tcd)
    n, k, d = topo.n_clients, topo.n_clouds, teng.d_params
    for t in range(2):
        draws = reference_draws(0, t, n, steps, jfl.local_batch,
                                _DATA["samples_per_client"], ref_steps,
                                jfl.ref_samples, d=d, k=k,
                                edge_fold=teng.edge_noise_fold)
        if tfl.attack == "gaussian":
            m = int(teng.static.clients_per_round)
            key = jengine.round_key(jnp.int32(0), jnp.int32(t))
            draws = draws._replace(attack_noise=torch.tensor(
                np.asarray(jax.random.normal(key, (m, d)))))
        jstate, jout = eng.step(jstate, jcd, t)
        tstate, tout = teng.step(tstate, tcd, t, draws)
        delivered = np.asarray(jout.delivered)
        assert np.array_equal(tout.delivered.numpy(), delivered)
        assert np.array_equal(teng.host_round_accounting(delivered[None]),
                              eng.host_round_accounting(delivered[None],
                                                        t0=t))
        assert rel(tstate.rep_ema.numpy(), jstate.rep_ema) <= 1e-4
        assert rel(flat(tstate.params), flat(jstate.params)) <= 1e-4
        assert rel(tstate.feat_sep.numpy(), jstate.feat_sep) <= 1e-4
    # entries one wire rounds differently (a level flip) move by about a
    # level; every other entry agrees within 1e-4
    for name in ("res_client", "res_edge"):
        a, b = getattr(tstate, name).numpy(), np.asarray(getattr(jstate,
                                                                 name))
        if a.size == 0:                   # that wire is lossless here
            assert b.size == 0
            continue
        flips = np.abs(a - b) > 1e-3 * np.abs(b).max(axis=1, keepdims=True)
        print(f"{override}: {name} {int(flips.sum())} flipped entries, "
              f"{rel(a[~flips], b[~flips]):.2e} off them")
        assert flips.sum() <= 1e-3 * flips.size, name
        assert rel(a[~flips], b[~flips]) <= 1e-4, name
        assert np.abs(b).max() > 0, name
