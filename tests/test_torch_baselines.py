"""The port's flat Byzantine-robust baselines against the reference on
identical inputs: the five aggregators of ``core.robust`` on seeded
numpy inputs, then chained replayed rounds of the flat branch of
``Engine.step`` against ``CompiledEngine.step`` for every baseline at the
suite's small topology (3 clouds x 4 clients, 6 selected; the CNN at full
width, D = 545,098), plus a CPU run of every method.

Tolerances: the aggregators within 1e-5 relative (fp32 sums in another
order), ``coordinate_median`` exact (it is a sort and one midpoint);
replayed rounds as ``_torch_replay.replay`` states them — masks, bytes
and $ exact, params within 1e-4, residuals within 1e-4 off the entries
one run's wire rounds differently (fp16 and QSGD flips, ``ROADMAP.md``
C.3–C.4), those entries bounded.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_replay import SMALL, SMALL_DATA, replay
from repro.core import robust as jrobust
from repro.federated import engine as jengine
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch.compress import TopKCodec
from repro_torch.configs.base import FLConfig
from repro_torch.core import robust
from repro_torch.federated import engine as tengine
from repro_torch.federated.simulation import (make_data, make_topology,
                                              run_simulation)

CPU = torch.device("cpu")
HEADLINE = dict(attack="label_flip", malicious_frac=0.3, compressor="topk",
                compress_ratio=0.1, link_policy="cross_only")
BASELINES = ("fedavg", "krum", "trimmed_mean", "median", "fltrust")


def _updates(n: int, d: int = 257, seed: int = 0):
    rng = np.random.default_rng(seed + n)
    u = (rng.standard_normal((n, d)) * 1e-2).astype(np.float32)
    ref = (u.mean(0) + rng.standard_normal(d) * 5e-3).astype(np.float32)
    return u, ref


def _both(name: str, u: np.ndarray, ref: np.ndarray):
    ctx_j = dict(n_malicious=2, multi=3, trim_frac=0.2,
                 ref_update=jnp.asarray(ref),
                 weights=jnp.arange(1, len(u) + 1, dtype=jnp.float32))
    ctx_t = dict(n_malicious=2, multi=3, trim_frac=0.2,
                 ref_update=torch.tensor(ref),
                 weights=torch.arange(1, len(u) + 1, dtype=torch.float32))
    want = np.asarray(jrobust.AGGREGATORS[name](jnp.asarray(u), ctx_j))
    got = robust.AGGREGATORS[name](torch.tensor(u), ctx_t).numpy()
    return got, want


@pytest.mark.parametrize("n", [9, 10])
@pytest.mark.parametrize("name", BASELINES)
def test_aggregator_matches_reference(name, n):
    u, ref = _updates(n)
    got, want = _both(name, u, ref)
    assert got.shape == want.shape == (u.shape[1],)
    if name == "median":
        assert np.array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_krum_and_trimmed_mean_pick_the_reference_rows():
    """Krum's selection and the trimmed mean's cut, made visible: far
    outliers must be the rows both leave out."""
    u, ref = _updates(10)
    u[[2, 7]] += 1.0
    for name in ("krum", "trimmed_mean", "median"):
        got, want = _both(name, u, ref)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
        assert np.abs(got).max() < 0.1, name
    got = robust.krum(torch.tensor(u), 2, multi=1).numpy()
    rows = [i for i in range(10) if np.allclose(got, u[i])]
    want = np.asarray(jrobust.krum(jnp.asarray(u), 2, multi=1))
    assert len(rows) == 1 and np.allclose(want, u[rows[0]])


@pytest.mark.parametrize("case", ["zero_rows", "no_trust"])
def test_fltrust_eps_handling_matches_reference(case):
    """``agg_weights`` takes max(‖g‖, eps) and max(Σ TS, eps) as
    ``robust.fltrust`` does: zero (dropped) rows get TS = 0, and when no
    row aligns with the reference the aggregate is 0."""
    u, ref = _updates(8)
    if case == "zero_rows":
        u[[0, 5]] = 0.0
    else:
        ref = -np.abs(ref) * np.sign(u.sum(0))
        u = np.abs(u) * np.sign(u.sum(0))
    want = np.asarray(jrobust.fltrust(jnp.asarray(u), jnp.asarray(ref)))
    got = robust.fltrust(torch.tensor(u), torch.tensor(ref)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-9)
    if case == "no_trust":
        assert not got.any() and not want.any()


def test_fltrust_goes_through_weighted_agg(monkeypatch):
    from repro_torch.kernels import ops
    calls = []
    orig = ops.weighted_agg

    def spy(*args, **kw):
        calls.append(kw.get("seg"))
        return orig(*args, **kw)
    monkeypatch.setattr(ops, "weighted_agg", spy)
    u, ref = _updates(6)
    robust.fltrust(torch.tensor(u), torch.tensor(ref))
    assert calls == [None]          # one call, one segment


def test_coordinate_median_averages_the_middle_pair():
    u = torch.tensor([[1.0], [4.0], [2.0], [8.0]])
    assert float(robust.coordinate_median(u)) == 3.0
    assert float(robust.coordinate_median(u[:3])) == 2.0


# -- replayed flat rounds ----------------------------------------------------

@pytest.mark.parametrize("method,wire", [
    ("fedavg", "topk"), ("fedavg", "qsgd"), ("krum", "topk"),
    ("trimmed_mean", "topk"), ("median", "topk"), ("fltrust", "topk")])
def test_baseline_rounds_match_reference(method, wire, monkeypatch):
    """Three replayed rounds of each baseline at the headline's knobs
    (label_flip, 30% malicious, top-k 0.1 on cross-cloud links), and
    FedAvg once with QSGD (15 levels) on the cross-cloud client uplinks
    instead; the flat client wire's noise comes from the reference's
    codec sub-folds (0 intra, 1 cross)."""
    cfg = {**SMALL, **HEADLINE}
    if wire == "qsgd":
        cfg.update(compressor="qsgd", qsgd_levels=15)
    drifts = replay(cfg, method, rounds=3, monkeypatch=monkeypatch)
    for t, dr in enumerate(drifts):
        print(f"{method}/{wire} round {t}: {dr}")


def test_flat_qsgd_on_every_link_matches_reference(monkeypatch):
    """``link_policy="all"``: the port runs the intra and cross passes as
    one round trip, each row's noise from its own sub-fold; two replayed
    rounds equal the reference's two passes."""
    cfg = {**SMALL, **HEADLINE, "compressor": "qsgd", "link_policy": "all"}
    replay(cfg, "krum", rounds=2, monkeypatch=monkeypatch)


def test_flat_wire_is_one_round_trip_a_round(monkeypatch):
    """Under ``cross_only`` and under ``all`` the flat client wire runs
    the top-k round trip once a round (one ``topk_mask`` launch on the
    card), over the selected rows; there is no edge wire."""
    calls = []
    orig = TopKCodec.roundtrip

    def spy(self, x, noise=None):
        calls.append(tuple(x.shape))
        return orig(self, x, noise)
    monkeypatch.setattr(TopKCodec, "roundtrip", spy)
    for policy in ("cross_only", "all"):
        calls.clear()
        fl = FLConfig(**{**SMALL, **HEADLINE, "link_policy": policy})
        topo = make_topology(fl)
        eng = tengine.Engine(tengine.static_from(fl, topo, "fedavg"), CPU)
        assert eng.client_wire_active and not eng.edge_wire_active
        cd = tengine.make_client_data(fl, topo, make_data(fl, **SMALL_DATA),
                                      0, device=CPU)
        state, _ = eng.step(eng.init_state(0), cd, 0)
        assert calls == [(fl.clients_per_round, eng.d_params)], policy
        assert state.res_edge.numel() == 0


def test_flat_own_mode_noise_reads_the_sub_folds():
    fl = FLConfig(**{**SMALL, **HEADLINE, "compressor": "qsgd"})
    topo = make_topology(fl)
    flat = tengine.Engine(tengine.static_from(fl, topo, "fedavg"), CPU)
    hier = tengine.Engine(tengine.static_from(fl, topo), CPU)
    agg = topo.aggregator_cloud
    inside = int(np.nonzero(topo.cloud_of == agg)[0][0])
    outside = int(np.nonzero(topo.cloud_of != agg)[0][0])
    assert list(flat.client_sub[[inside, outside]]) == [0, 1]
    a = flat.client_noise(0, 1, [outside, inside])
    assert torch.equal(a[0], flat._noise_rows(0, 1, [(211, 1, outside)])[0])
    assert torch.equal(a[1], flat._noise_rows(0, 1, [(211, 0, inside)])[0])
    assert not torch.equal(a[0], hier.client_noise(0, 1, [outside])[0])


# -- every method runs -------------------------------------------------------

@pytest.mark.parametrize("method", jengine.METHODS)
def test_every_reference_method_runs(method):
    fl = FLConfig(**{**SMALL, **HEADLINE})
    r = run_simulation(fl, method=method, rounds=2, eval_every=1,
                       device="cpu", data=make_data(fl, **SMALL_DATA))
    assert r.method == method and r.rounds == [1, 2]
    assert 0.0 <= r.final_accuracy <= 1.0
    assert np.all(np.isfinite(r.reputation))
    d = 545_098
    k_bytes = TopKCodec(0.1).payload_bytes(d)
    if method == "cost_trustfl":
        assert r.cross_bytes == 2 * 2 * k_bytes       # two cross edges
    else:   # each client's one uplink: fp32 inside, top-k across
        assert (r.intra_bytes % (4 * d), r.cross_bytes % k_bytes) == (0, 0)
        assert (r.intra_bytes / (4 * d) + r.cross_bytes / k_bytes
                == 2 * fl.clients_per_round)
