"""The port's scenario registry and the three ``JitHooks`` the round
engine reads, against the reference: the registry itself, the dropout
mask, then replayed rounds of ``Engine.step`` against
``CompiledEngine.step`` under ``dropout`` (Cost-TrustFL, FedAvg and
FLTrust), ``alie_sleeper`` (malice warmup 2) and ``price_surge`` (c_cross
×(1, 2, 4, 2)), at the suite's small topology; then every registered
scenario through ``run_simulation`` and ``compare_methods`` on the CPU.

Tolerances as ``_torch_replay.replay`` states them: masks, bytes and $
exact; reputation and params within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_replay import SMALL, SMALL_DATA, replay
from repro import scenarios as jscenarios
from repro.configs.base import FLConfig as JFLConfig
from repro.federated import engine as jengine
from repro_torch import scenarios
from repro_torch.configs.base import FLConfig
from repro_torch.core.cost import CostModel
from repro_torch.federated import FLServer
from repro_torch.federated import engine as tengine
from repro_torch.federated import simulation
from repro_torch.federated.simulation import (make_data, make_topology,
                                              run_simulation)

CPU = torch.device("cpu")
TOPK = dict(compressor="topk", compress_ratio=0.1, link_policy="cross_only")


# -- the registry ------------------------------------------------------------

def test_registry_matches_reference():
    names = scenarios.list_scenarios()
    assert names == jscenarios.list_scenarios() and len(names) == 13
    for level in scenarios.LEVELS:
        assert (scenarios.list_scenarios(level)
                == jscenarios.list_scenarios(level))
    for name in names:
        got, want = scenarios.get_scenario(name), jscenarios.get_scenario(name)
        assert (got.level, got.description, got.overrides, got.knobs) == (
            want.level, want.description, want.overrides, want.knobs), name
        assert got.jittable == want.jittable, name
        for hook in ("on_round_start", "deliver", "malicious_now"):
            assert ((getattr(got, hook) is None)
                    == (getattr(want, hook) is None)), (name, hook)
        if want.jit_hooks is None:
            assert got.jit_hooks is None, name
        else:
            assert (got.jit_hooks.p_drop, got.jit_hooks.malice_warmup,
                    got.jit_hooks.price_multipliers) == (
                want.jit_hooks.p_drop, want.jit_hooks.malice_warmup,
                want.jit_hooks.price_multipliers), name


def test_scenario_apply_and_registry_errors():
    fl = FLConfig()
    drop = scenarios.get_scenario("dropout")
    out = drop.apply(fl)
    assert (out.attack, out.malicious_frac) == ("none", 0.0)
    assert drop.apply(out) == out                      # idempotent
    assert scenarios.Scenario("plain", "static").apply(fl) is fl
    with pytest.raises(KeyError, match="unknown scenario"):
        scenarios.get_scenario("nope")
    with pytest.raises(ValueError, match="already registered"):
        scenarios.register_scenario(drop)
    with pytest.raises(ValueError, match="level"):
        scenarios.Scenario("x", "nope")


def test_static_reads_the_jit_hooks():
    fl = FLConfig(**SMALL)
    topo = make_topology(fl)
    plain = tengine.static_from(fl, topo)
    assert (plain.p_drop, plain.malice_warmup, plain.price_multipliers) == (
        0.0, 0, (1.0,))
    st = tengine.static_from(fl, topo, "fedavg",
                             scenarios.get_scenario("dropout"))
    assert (st.p_drop, st.hierarchical, st.multi_features) == (0.3, False,
                                                               False)
    st = tengine.static_from(fl, topo, scenario=scenarios.get_scenario(
        "price_surge"))
    assert st.price_multipliers == (1.0, 2.0, 4.0, 2.0)
    assert [st.c_cross_at(t) for t in range(5)] == [
        float(np.float32(fl.c_cross) * np.float32(m))
        for m in (1.0, 2.0, 4.0, 2.0, 1.0)]
    with pytest.raises(ValueError, match="unknown method"):
        tengine.static_from(fl, topo, "nope")


@pytest.mark.parametrize("case", ["some", "none_survive", "none_selected"])
def test_dropout_mask_matches_reference(case):
    """``Engine.deliver`` against the reference's ``build_deliver_fn`` on
    the reference's own uniforms: drop below p_drop, never drop a whole
    round (``none_survive`` searches for a key that drops every selected
    client)."""
    fl = FLConfig(**SMALL)
    topo = make_topology(fl)
    eng = tengine.Engine(tengine.static_from(
        fl, topo, "fedavg", scenarios.get_scenario("dropout")), CPU)
    jdeliver = jengine.build_deliver_fn(jengine.static_from(
        JFLConfig(**SMALL), topo, "fedavg",
        jscenarios.get_scenario("dropout")))
    n = topo.n_clients
    sel = np.zeros(n, bool)
    if case != "none_selected":
        sel[np.random.default_rng(3).choice(n, 6, replace=False)] = True
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(20_000))
    us = np.asarray(jax.vmap(lambda kk: jax.random.uniform(kk, (n,)))(keys))
    i = 0
    if case == "none_survive":
        i = int(np.nonzero((us[:, sel] < 0.3).all(axis=1))[0][0])
    want = np.asarray(jdeliver(jnp.asarray(sel), keys[i]))
    draws = tengine.RoundDraws(None, None, None,
                               drop_u=torch.tensor(us[i]))
    got = eng.deliver(torch.tensor(sel), draws).numpy()
    assert np.array_equal(got, want)
    assert not (got & ~sel).any()
    if case == "none_survive":
        assert got.sum() == 1 and got[np.argmax(sel)]
    elif case == "none_selected":
        assert not got.any()
    else:
        assert np.array_equal(got, sel & (us[i] >= 0.3))
        assert 0 < got.sum() < sel.sum()


# -- replayed rounds under the hooks -----------------------------------------

@pytest.mark.parametrize("method", ["cost_trustfl", "fedavg", "fltrust"])
def test_dropout_rounds_match_reference(method, monkeypatch):
    """Three replayed rounds under ``dropout`` (p_drop 0.3, no attack) at
    the headline wire (top-k 0.1, cross_only): the delivered masks, the
    zeroed non-delivered rows and, for Cost-TrustFL, the trust stage and
    ``weighted_agg`` over rows with w = 0."""
    cfg = {**SMALL, **TOPK}
    drifts = replay(cfg, method, "dropout", rounds=3,
                    monkeypatch=monkeypatch)
    for t, dr in enumerate(drifts):
        print(f"dropout/{method} round {t}: {dr}")


def test_alie_sleeper_rounds_match_reference():
    """``alie_sleeper``: honest for 2 rounds, then ALIE from round 2."""
    replay(dict(SMALL), "cost_trustfl", "alie_sleeper", rounds=3)


def test_price_surge_rounds_match_reference():
    """``price_surge``: four replayed rounds cover the ×(1, 2, 4, 2)
    cycle; selection (Eq. 10 reads the round's c_cross) and $ exact at
    each multiplier, and the $ billed at c_cross·mult[t]."""
    replay(dict(SMALL), "cost_trustfl", "price_surge", rounds=4)
    fl = scenarios.get_scenario("price_surge").apply(FLConfig(**SMALL))
    topo = make_topology(fl)
    server = FLServer(fl, topo, make_data(fl, **SMALL_DATA),
                      scenario="price_surge", device="cpu")
    for t, mult in enumerate((1.0, 2.0, 4.0, 2.0, 1.0)):
        met = server.run_round(t)
        cm = CostModel(fl.c_intra, fl.c_cross * mult)
        kw = dict(client_payload=server._eng.client_payload,
                  edge_payload=server._eng.edge_payload)
        assert met.cost == cm.round_cost(topo, met.selected,
                                         server.d_params, **kw)
        assert met.extra["cross_bytes"] == cm.round_bytes(
            topo, met.selected, server.d_params, **kw)[1]


# -- every registered scenario runs ------------------------------------------

@pytest.mark.parametrize("name", scenarios.list_scenarios())
def test_every_scenario_runs(name):
    fl = FLConfig(**SMALL)
    r = run_simulation(fl, scenario=name, rounds=1, device="cpu",
                       data=make_data(fl, **SMALL_DATA))
    assert r.scenario == name
    assert r.attack == scenarios.get_scenario(name).overrides["attack"]
    assert 0.0 <= r.final_accuracy <= 1.0
    assert np.all(np.isfinite(r.reputation)) and r.total_cost > 0


def test_compare_methods_shares_one_dataset(monkeypatch):
    made, seen = [], []
    small = simulation.make_data

    def make(flcfg, dataset="cifar10", seed=0):
        made.append(flcfg)
        return small(flcfg, dataset, seed, **SMALL_DATA)
    monkeypatch.setattr(simulation, "make_data", make)
    init = FLServer.__post_init__

    def post_init(self):
        seen.append(self.data)
        init(self)
    monkeypatch.setattr(FLServer, "__post_init__", post_init)
    methods = ["cost_trustfl", "fedavg", "fltrust"]
    out = simulation.compare_methods(FLConfig(**SMALL), methods,
                                     scenario="dropout", rounds=1,
                                     device="cpu")
    assert list(out) == methods and len(made) == 1
    assert made[0].attack == "none"            # overrides came first
    assert len(seen) == 3 and all(d is seen[0] for d in seen)
    for m, r in out.items():
        assert (r.method, r.scenario, r.attack) == (m, "dropout", "none")
        assert r.total_cost > 0
