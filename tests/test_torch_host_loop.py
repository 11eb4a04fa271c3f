"""The port's host round loop (``FLServer(engine="host")``) against the
reference's (``repro.federated.server.FLServer(engine="host")``), its
tensor draws replayed through ``_torch_replay.host_reference_draws`` at
the suite's small topology (3 clouds x 4 clients, 6 selected; the CNN at
full width, D = 545,098): every method with no codec, without an attack
and under the gaussian attack, Cost-TrustFL at the headline knobs
(top-k 0.1 ``cross_only``) and at the defense knobs (QSGD 15 ``all``,
``multi``), ``dropout`` under Krum, trimmed mean and median (the
configurations only this loop runs), ``intermittent`` and
``price_surge`` through their host hooks, and a scenario with a
``deliver`` hook and no ``jit_hooks``. Then the routing
(``resolve_engine`` against the reference's for every method, registered
scenario and ``engine=``), own-mode selection against the reference
without replay, and the entry points' ``engine=``.

Tolerances as ``_torch_replay.host_replay`` states them: masks, bytes
and $ exact; reputation, params and feature separability within 1e-4
relative.
"""
import numpy as np
import pytest
import torch

from _torch_replay import SMALL, SMALL_DATA, host_replay
from repro import scenarios as jscenarios
from repro.configs.base import FLConfig as JFLConfig
from repro.federated import engine as jengine
from repro.federated.server import FLServer as JFLServer
from repro.federated.simulation import make_data as jmake_data
from repro.federated.simulation import make_topology as jmake_topology
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch import scenarios
from repro_torch.configs.base import FLConfig
from repro_torch.federated import FLServer, compare_methods, simulation
from repro_torch.federated import engine as tengine
from repro_torch.federated.simulation import make_data, make_topology

METHODS = ("cost_trustfl", "fedavg", "krum", "trimmed_mean", "median",
           "fltrust")
TOPK = dict(compressor="topk", compress_ratio=0.1, link_policy="cross_only")
HEADLINE = dict(attack="label_flip", malicious_frac=0.3, **TOPK)
DEFENSE = dict(attack="alie_norm", malicious_frac=0.3,
               trust_features="multi", compressor="qsgd", qsgd_levels=15,
               link_policy="all")


def _show(tag, drifts):
    for t, dr in enumerate(drifts):
        print(f"{tag} round {t}: "
              + ", ".join(f"{k} {v:.1e}" for k, v in dr.items()))


@pytest.mark.parametrize("method", METHODS)
def test_methods_match_reference_host_loop(method):
    """The default ``FLConfig`` knobs (no codec, no attack)."""
    _show(method, host_replay(dict(SMALL), method, rounds=3))


@pytest.mark.parametrize("method", METHODS)
def test_gaussian_attack_matches_reference_host_loop(method, monkeypatch):
    """30% gaussian attackers (σ = 1, the normals replayed over the
    delivered rows), no codec. Where the noise passes into the params
    (FedAvg; the trimmed mean, which trims int(0.15·6) = 0 rows), the
    next rounds train from weights far from any optimum, and a client's
    update can sit at a ReLU or max-pool switch point (``ROADMAP.md``
    C.5, measured: FedAvg round 1, client 9, 3.7e-3 apart in the port's
    batched and single-client runs alike): ``host_replay``'s spy records
    it (``rows_apart``) and holds the contract until then."""
    _show(f"gaussian/{method}", host_replay(
        dict(SMALL, attack="gaussian", malicious_frac=0.3), method,
        rounds=3, monkeypatch=monkeypatch))


@pytest.mark.parametrize("knobs", ["headline", "defense"])
def test_cost_trustfl_wires_match_reference_host_loop(knobs):
    """The edge wire as ``cloud_transform`` (headline: top-k across
    clouds), and the client wire with per-sender QSGD noise plus the
    multi-feature gate (defense)."""
    cfg = dict(SMALL, **(HEADLINE if knobs == "headline" else DEFENSE))
    _show(knobs, host_replay(cfg, rounds=3))


@pytest.mark.parametrize("method", ["krum", "trimmed_mean", "median"])
def test_dropout_order_statistics_match_reference_host_loop(method):
    """Dropout under an order statistic: only the host loop runs it. The
    aggregate takes the delivered rows only (Krum's f and multi from
    their count), the flat wire top-k across clouds."""
    cfg = dict(SMALL, **TOPK)
    fl = scenarios.get_scenario("dropout").apply(FLConfig(**cfg))
    assert tengine.resolve_engine("auto", fl, make_topology(fl), method,
                                  scenarios.get_scenario("dropout")) == "host"
    _show(f"dropout/{method}", host_replay(cfg, method, "dropout", rounds=3))


@pytest.mark.parametrize("name,rounds", [("intermittent", 3),
                                         ("price_surge", 4)])
def test_host_hooks_match_reference_host_loop(name, rounds):
    """``intermittent``'s malice hook (honest before round 3) and
    ``price_surge``'s round-start hook (c_cross ×(1, 2, 4, 2): Eq. 10 and
    the round's $ at the swapped cost model; 4 rounds, the whole
    cycle)."""
    _show(name, host_replay(dict(SMALL), "cost_trustfl", name,
                            rounds=rounds))


def test_deliver_hook_without_jit_hooks_matches_reference():
    """A scenario with a host ``deliver`` hook and no ``jit_hooks``: auto
    routes it to the host loop, which calls the hook on the round's numpy
    generator after selection."""
    jscen = jscenarios.Scenario("straggle", "environment",
                                deliver=jscenarios.make_dropout_hook(0.5))
    tscen = scenarios.Scenario("straggle", "environment",
                               deliver=scenarios.make_dropout_hook(0.5))
    assert not tscen.jittable
    fl = FLConfig(**SMALL)
    assert tengine.resolve_engine("auto", fl, make_topology(fl), "fedavg",
                                  tscen) == "host"
    _show("straggle", host_replay(dict(SMALL), "fedavg", (jscen, tscen),
                                  rounds=3))


# -- routing ------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["auto", "jit", "host"])
def test_resolve_engine_matches_reference(engine):
    """Every method × registered scenario (and none, and a host-hook
    scenario without ``jit_hooks``): the reference's answer on one
    device, or the same exception type."""
    def host_hook(*args):
        raise AssertionError
    extra = [(jscenarios.Scenario("h", "environment", deliver=host_hook),
              scenarios.Scenario("h", "environment", deliver=host_hook))]
    pairs = [(None, None)] + [(jscenarios.get_scenario(n),
                               scenarios.get_scenario(n))
                              for n in scenarios.list_scenarios()] + extra
    routes = set()
    for method in METHODS:
        for jsc, tsc in pairs:
            jfl, tfl = JFLConfig(**SMALL), FLConfig(**SMALL)
            if jsc is not None:
                jfl, tfl = jsc.apply(jfl), tsc.apply(tfl)
            try:
                want = jengine.resolve_engine(engine, jfl, jmake_topology(jfl),
                                              method, jsc, n_devices=1)
            except ValueError:
                with pytest.raises(ValueError, match="not jittable"):
                    tengine.resolve_engine(engine, tfl, make_topology(tfl),
                                           method, tsc)
                routes.add("refused")
                continue
            got = tengine.resolve_engine(engine, tfl, make_topology(tfl),
                                         method, tsc)
            assert got == want, (method, getattr(tsc, "name", None))
            assert got == "host" or tengine.supports(tfl, method, tsc)
            routes.add(got)
    assert routes == {"auto": {"jit", "host"}, "jit": {"jit", "refused"},
                      "host": {"host"}}[engine]


@pytest.mark.parametrize("method,scenario", [("cost_trustfl", None),
                                             ("fedavg", None),
                                             ("median", "dropout")])
def test_own_mode_first_selection_matches_reference(method, scenario):
    """Without replay, the round-0 delivered mask is the reference's: the
    host loop selects and delivers from the round's numpy generator, and
    round 0 reads only the initial reputations."""
    cfg = dict(SMALL, **TOPK)
    jfl, tfl = JFLConfig(**cfg), FLConfig(**cfg)
    jsc = tsc = None
    if scenario is not None:
        jsc, tsc = (jscenarios.get_scenario(scenario),
                    scenarios.get_scenario(scenario))
        jfl, tfl = jsc.apply(jfl), tsc.apply(tfl)
    want = JFLServer(jfl, jmake_topology(jfl), jmake_data(
        jfl, "cifar10", seed=0, **SMALL_DATA), method=method, scenario=jsc,
        engine="host").run_round(0)
    server = FLServer(tfl, make_topology(tfl), make_data(tfl, **SMALL_DATA),
                      method=method, scenario=tsc, device="cpu",
                      engine="host")
    got = server.run_round(0)
    assert server.engine_resolved == "host" and server.round_state is None
    assert np.array_equal(got.selected, np.asarray(want.selected))
    assert (got.cost, got.extra) == (want.cost, want.extra)
    for name, p in server.params.items():
        assert bool(torch.isfinite(p).all()), name


def test_entry_points_forward_engine(monkeypatch):
    """``run_simulation`` and ``compare_methods`` pass ``engine=`` to the
    server: auto routes dropout under Krum to the host loop, ``jit``
    refuses it, ``host`` takes FedAvg, which auto would give the engine."""
    fl = FLConfig(**SMALL)
    data = make_data(fl, **SMALL_DATA)
    routed = []
    init = FLServer.__post_init__

    def post_init(self):
        init(self)
        routed.append((self.method, self.engine_resolved))
    monkeypatch.setattr(FLServer, "__post_init__", post_init)
    r = simulation.run_simulation(fl, method="krum", scenario="dropout",
                                  rounds=2, eval_every=1, device="cpu",
                                  data=data)
    assert r.rounds == [1, 2] and r.total_cost > 0
    assert np.all(np.isfinite(r.reputation))
    with pytest.raises(ValueError, match="not jittable"):
        simulation.run_simulation(fl, method="krum", scenario="dropout",
                                  rounds=1, device="cpu", data=data,
                                  engine="jit")
    monkeypatch.setattr(simulation, "make_data",
                        lambda flcfg, dataset, seed: data)
    out = compare_methods(fl, ["fedavg", "median"], rounds=1, device="cpu",
                          engine="host")
    assert list(out) == ["fedavg", "median"]
    assert routed == [("krum", "host"), ("fedavg", "host"),
                      ("median", "host")]
