"""The port's mesh-sharded round engine (``repro_torch.federated.sharded``
on ``torch.distributed``) on the CPU with gloo: the support gates and the
routing against the reference's, the engine at world size 1 replayed
against the reference's ``CompiledShard.step`` at ``n_devices=1`` and
against the port's own ``Engine.step``, six spawned gloo ranks (mesh
3 x 2) and an explicit two-rank subgroup of them (mesh 1 x 2) against
world size 1, and the entry points (``FLServer(engine="shard")``,
``run_simulation_sharded``) end to end.

Tolerances: masks, float64 bytes and $ exact everywhere; reputation,
params and feature separability within 1e-4 relative at world size 1
(the reference's own shard tolerance: partial sums associate
differently), 1e-5 across world sizes. Images are cropped to 8 x 8
(D = 53,578), so the reference's round compiles in seconds.
"""
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import scenarios as jscenarios
from repro.configs.base import FLConfig as JFLConfig
from repro.core.fl_types import CloudTopology as JCloudTopology
from repro.federated import engine as jengine
from repro.federated import sharded as jsharded
from repro.federated.simulation import make_data as jmake_data
from repro.federated.simulation import make_topology as jmake_topology
from _torch_replay import flat as _jflat
from _torch_replay import reference_draws, rel
from _torch_shard_worker import (CPU, DEFENSE, HEADLINE, PAIR, ROUNDS, RUNS,
                                 SMALL, SMALL_DATA, narrow, record, setup,
                                 shard_rounds)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch import convert
from repro_torch import scenarios as tscenarios
from repro_torch.configs.base import FLConfig
from repro_torch.core.fl_types import CloudTopology
from repro_torch.federated import FLServer, run_simulation, \
    run_simulation_sharded
from repro_torch.federated import engine as tengine
from repro_torch.federated import sharded
from repro_torch.federated.simulation import make_topology as tmake_topology
from repro_torch.scenarios import Scenario
from repro_torch.telemetry import ListSink, Telemetry, validate_events

WORKER = Path(__file__).resolve().parent / "_torch_shard_worker.py"
# the reference's tests/test_sharded.py configuration
_FL = dict(n_clouds=3, clients_per_cloud=4, clients_per_round=6,
           local_epochs=1, local_batch=8, ref_samples=16,
           attack="sign_flip", malicious_frac=0.3, attack_scale=1.0)


@pytest.fixture
def group():
    """A one-rank gloo default group for the test, ended after it."""
    assert not dist.is_initialized()
    sharded.ensure_group(CPU)
    yield
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# (a) the gates, (b) the routing — against the reference's

@pytest.mark.parametrize("args", [(4, 1024, 8), (3, 12, 1), (3, 12, 3),
                                  (32, 1024, 8), (3, 12, 8), (3, 12, 24),
                                  (3, 12, 2), (3, 12, 6), (3, 90, 1)])
def test_mesh_axes_match_reference(args):
    assert sharded.mesh_axes(*args) == jsharded.mesh_axes(*args)


_HOSTY = dict(name="hosty", level="environment",
              deliver=lambda srv, t, rng, sel: sel)
_UNEVEN = (np.array([0] * 7 + [1] * 5), 2, 0)


@pytest.mark.parametrize("over,method,scenario,topo,n_devices", [
    (dict(attack="gaussian"), "cost_trustfl", None, None, None),
    (dict(attack="min_max"), "cost_trustfl", None, None, None),
    (dict(compressor="qsgd", compress_ratio=0.25, link_policy="all"),
     "cost_trustfl", None, None, None),
    *(({}, m, "dropout", None, None)
      for m in ("krum", "trimmed_mean", "median", "fedavg")),
    ({}, "cost_trustfl", "hosty", None, None),
    ({}, "cost_trustfl", None, "uneven", None),
    ({}, "cost_trustfl", None, None, 5),
    ({}, "cost_trustfl", None, None, 4),
    ({}, "sgd", None, None, None)])
def test_shard_unsupported_reason_matches_reference(over, method, scenario,
                                                    topo, n_devices):
    """The same refusals, in the same words (``n_devices`` None: one
    device in each package)."""
    jfl, tfl = JFLConfig(**{**_FL, **over}), FLConfig(**{**_FL, **over})
    if topo == "uneven":
        jtopo = JCloudTopology(*_UNEVEN)
        ttopo = CloudTopology(*_UNEVEN)
    else:
        jtopo, ttopo = jmake_topology(jfl), tmake_topology(tfl)
    if scenario == "hosty":
        jsc, tsc = jscenarios.Scenario(**_HOSTY), Scenario(**_HOSTY)
    elif scenario is not None:
        jsc = jscenarios.get_scenario(scenario)
        tsc = tscenarios.get_scenario(scenario)
    else:
        jsc = tsc = None
    want = jsharded.shard_unsupported_reason(jfl, jtopo, method, jsc,
                                             n_devices=n_devices)
    got = sharded.shard_unsupported_reason(tfl, ttopo, method, tsc,
                                           n_devices=n_devices)
    assert got == want
    assert sharded.supports_shard(tfl, method, tsc, topo=ttopo,
                                  n_devices=n_devices) == (want is None)


@pytest.mark.parametrize("n_devices", [1, 4])
@pytest.mark.parametrize("engine,over,method,scenario,uneven", [
    ("auto", {}, "cost_trustfl", None, False),
    ("auto", dict(clients_per_round=3), "fedavg", None, False),
    ("shard", dict(clients_per_round=3), "fedavg", None, False),
    ("auto", dict(attack="gaussian"), "cost_trustfl", None, False),
    ("auto", {}, "krum", "dropout", False),
    ("auto", {}, "cost_trustfl", "dropout", False),
    ("auto", {}, "cost_trustfl", None, True),
    ("shard", {}, "cost_trustfl", None, True),
    ("shard", dict(attack="gaussian"), "cost_trustfl", None, False),
    ("jit", {}, "krum", "dropout", False),
    ("host", {}, "krum", None, False),
    ("tpu", {}, "cost_trustfl", None, False)])
def test_resolve_engine_matches_reference(engine, over, method, scenario,
                                          uneven, n_devices):
    """The reference's routing at 1 and 4 devices: the same loop, or a
    ``ValueError`` with the same message."""
    jfl, tfl = JFLConfig(**{**_FL, **over}), FLConfig(**{**_FL, **over})
    jsc = tsc = None
    if scenario is not None:
        jsc = jscenarios.get_scenario(scenario)
        tsc = tscenarios.get_scenario(scenario)
        jfl, tfl = jsc.apply(jfl), tsc.apply(tfl)
    jtopo, ttopo = ((JCloudTopology(*_UNEVEN), CloudTopology(*_UNEVEN))
                    if uneven else (jmake_topology(jfl), tmake_topology(tfl)))
    try:
        want = jengine.resolve_engine(engine, jfl, jtopo, method, jsc,
                                      n_devices=n_devices)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tengine.resolve_engine(engine, tfl, ttopo, method, tsc,
                                   n_devices=n_devices)
        assert str(got.value) == str(e)
        return
    assert tengine.resolve_engine(engine, tfl, ttopo, method, tsc,
                                  n_devices=n_devices) == want


def test_auto_on_one_rank_never_shards():
    """Without a group (one rank) ``"auto"`` routes as the reference does
    on one device: never to the sharded engine."""
    fl = FLConfig(**_FL)
    topo = tmake_topology(fl)
    assert not dist.is_initialized()
    assert tengine.resolve_engine("auto", fl, topo, "cost_trustfl") == "jit"
    assert tengine.resolve_engine("shard", fl, topo, "fedavg") == "shard"


# ---------------------------------------------------------------------------
# (c) world size 1 against the reference's CompiledShard at n_devices=1

def _reference_shard(cfg: dict, method: str, scenario):
    jfl = JFLConfig(**cfg)
    jsc = None
    if scenario is not None:
        jsc = jscenarios.get_scenario(scenario)
        jfl = jsc.apply(jfl)
    topo = jmake_topology(jfl)
    jdata = narrow(jmake_data(jfl, "cifar10", seed=0, **SMALL_DATA))
    eng = jsharded.engine_for(jfl, topo, jdata, method, jsc, n_devices=1)
    cd = eng.stage_data(jengine.make_client_data(jfl, topo, jdata, 0))
    return eng, cd, eng.init_state(0)


def _drifts(a, b, keys=("rep", "params", "feat_sep")) -> dict:
    return {k: rel(a[k], b[k]) for k in keys if np.asarray(b[k]).size}


@pytest.mark.parametrize("knobs,method,scenario", [
    (HEADLINE, "cost_trustfl", None),
    (DEFENSE, "cost_trustfl", None),
    (HEADLINE, "fedavg", None),
    (dict(HEADLINE, attack="sign_flip"), "krum", None),
    (HEADLINE, "fltrust", None),
    (dict(compressor="topk", compress_ratio=0.1, link_policy="cross_only"),
     "cost_trustfl", "dropout")],
    ids=["headline", "defense", "fedavg", "krum", "fltrust", "dropout"])
def test_world_size_one_matches_reference_shard(knobs, method, scenario,
                                                group):
    """2 replayed rounds of the port's ``ShardEngine.step`` (one gloo
    rank) against ``CompiledShard.step`` on a 1 x 1 mesh, from its
    initial state on its draws: masks, bytes and $ exact; reputation,
    params and separability within 1e-4."""
    cfg = {**SMALL, **knobs}
    jeng, jcd, jstate = _reference_shard(cfg, method, scenario)
    fl, topo, data, sc = setup(knobs, scenario)
    eng = sharded.engine_for(fl, topo, data, method, sc, device=CPU,
                             n_devices=1)
    assert (eng.shard_static.kc, eng.shard_static.pc) == (1, 1)
    cd = eng.stage_data(tengine.make_client_data(fl, topo, data, 0,
                                                 device=CPU))
    state = convert.round_state_from_numpy(
        {k: np.asarray(v) for k, v in jstate.params.items()},
        np.asarray(jstate.rep_ema), np.asarray(jstate.res_edge), 0,
        device=CPU, res_client=np.asarray(jstate.res_client),
        feat_sep=np.asarray(jstate.feat_sep))
    inner = eng.eng
    steps, ref_steps = inner.schedule(cd)
    noisy = inner.client_wire_noise or inner.edge_wire_noise
    for t in range(ROUNDS):
        jstate, jout = jeng.step(jstate, jcd, t)
        jax.block_until_ready(jstate)
        draws = reference_draws(
            0, t, eng.n, steps, fl.local_batch,
            SMALL_DATA["samples_per_client"], ref_steps, fl.ref_samples,
            d=eng.d_params if noisy else 0, k=eng.k,
            edge_fold=inner.edge_noise_fold,
            client_sub=None if eng.hier else inner.client_sub)
        state, out = eng.step(state, cd, t, draws)
        delivered = np.asarray(jout.delivered)
        assert np.array_equal(out.delivered.numpy(), delivered), t
        assert np.array_equal(
            eng.host_round_accounting(delivered[None], t0=t),
            jeng.host_round_accounting(delivered[None], t0=t)), t
        drift = _drifts(
            dict(rep=state.rep_ema.numpy(), params=_jflat(
                convert.params_to_numpy(state.params)),
                feat_sep=state.feat_sep.numpy()),
            dict(rep=np.asarray(jstate.rep_ema),
                 params=_jflat(jstate.params),
                 feat_sep=np.asarray(jstate.feat_sep)))
        print(f"{method} {scenario} round {t}: {drift}")
        assert max(drift.values()) <= 1e-4, (t, drift)


# ---------------------------------------------------------------------------
# (d) world size 1 against the port's own Engine.step

@pytest.mark.parametrize("knobs,method,scenario", [
    (dict(_FL, attack="scaling"), "cost_trustfl", None),
    (dict(_FL, attack="alie"), "cost_trustfl", None),
    (dict(_FL, attack="ipm"), "cost_trustfl", None),
    (dict(_FL, attack="collusion"), "cost_trustfl", None),
    (dict(_FL, attack="alie_norm", trust_features="multi"), "fedavg", None),
    (_FL, "trimmed_mean", None),
    (_FL, "median", None),
    (dict(_FL, compressor="topk", compress_ratio=0.25, link_policy="all"),
     "cost_trustfl", None),
    (dict(_FL, compressor="topk", compress_ratio=0.25, link_policy="all"),
     "krum", None),
    (dict(_FL, compressor="qsgd", qsgd_levels=15, link_policy="cross_only"),
     "cost_trustfl", None),
    (dict(_FL, compressor="qsgd", qsgd_levels=15, link_policy="cross_only"),
     "median", None),
    (_FL, "cost_trustfl", "price_surge"),
    (dict(_FL, trust_features="multi"), "cost_trustfl", "intermittent"),
    (_FL, "fltrust", "dropout")],
    ids=["scaling", "alie", "ipm", "collusion", "fedavg-alie_norm",
         "trimmed_mean", "median", "topk-all", "krum-topk-all",
         "qsgd-cross_only", "median-qsgd-cross_only", "price_surge",
         "intermittent", "fltrust-dropout"])
def test_world_size_one_matches_engine(knobs, method, scenario, group):
    """2 rounds of ``ShardEngine.step`` against the port's ``Engine.step``
    on the same ``RoundDraws`` (own mode, the wire noise materialized),
    each from its own chained state: masks, bytes and $ exact;
    reputation, params and separability within 1e-4, the error-feedback
    residuals within 5e-2."""
    knobs = {k: v for k, v in knobs.items() if k not in SMALL}
    fl, topo, data, sc = setup(knobs, scenario)
    eng = sharded.engine_for(fl, topo, data, method, sc, device=CPU)
    ref = tengine.Engine(eng.static, CPU)
    full = tengine.make_client_data(fl, topo, data, 0, device=CPU)
    cd = eng.stage_data(full)
    a, b = ref.init_state(0), eng.init_state(0)
    for t in range(ROUNDS):
        draws = ref.draws(0, t, full, full_noise=True)
        a, oa = ref.step(a, full, t, draws)
        b, ob = eng.step(b, cd, t, draws)
        ra, rb = {}, {}
        record(ra, ref, a, oa, t)
        record(rb, eng, b, ob, t)
        assert np.array_equal(rb["delivered"][0], ra["delivered"][0]), t
        assert np.array_equal(rb["acct"][0], ra["acct"][0]), t
        drift = _drifts({k: v[0] for k, v in rb.items()},
                        {k: v[0] for k, v in ra.items()})
        assert max(drift.values()) <= 1e-4, (t, drift)
        # an entry within rounding of a top-k threshold, an fp16 boundary
        # or a QSGD level takes the other value in one run (ROADMAP.md
        # C.3-C.4), so the residuals are held as tests/_torch_replay.py
        # holds them in all
        for name in ("res_client", "res_edge"):
            x, y = getattr(b, name).numpy(), getattr(a, name).numpy()
            assert x.shape == y.shape
            if x.size:
                assert rel(x, y) <= 5e-2, (t, name)


# ---------------------------------------------------------------------------
# (e) spawned gloo ranks against world size 1

def test_spawned_ranks_match_world_size_one(tmp_path, group):
    """Six gloo ranks, each a process (``_torch_shard_worker.py``), run
    ``RUNS`` (defense, krum, fltrust; 2 own-mode rounds each) on the mesh
    3 x 2 of the world, then ranks ``PAIR`` run them again on the mesh
    1 x 2 of an explicit two-rank subgroup. Every rank's replicated
    outputs equal its group's first rank's, and those hold to the
    world-size-1 run of this process: masks, bytes and $ exact,
    reputation, params and separability within 1e-5. The spawned run has
    a time limit, past which the test fails."""
    world = 6
    assert sharded.mesh_axes(3, 12, world) == (3, 2)
    assert sharded.mesh_axes(3, 12, len(PAIR)) == (1, 2)
    out = tmp_path / "rank"
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(world),
         str(tmp_path / "store"), str(out)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0].decode()[-2000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), logs
    ranks = [dict(np.load(f"{out}_{r}.npz")) for r in range(world)]
    ones = {name: shard_rounds(knobs, method) for name, knobs, method in RUNS}
    for prefix, members in (("world/", range(world)), ("pair/", PAIR)):
        recs = [{k[len(prefix):]: v for k, v in ranks[r].items()
                 if k.startswith(prefix)} for r in members]
        for got in recs[1:]:
            assert got.keys() == recs[0].keys()
            for key, v in got.items():
                assert np.array_equal(v, recs[0][key]), (prefix, key)
        for name, one in ones.items():
            many = {k.split("/", 1)[1]: v for k, v in recs[0].items()
                    if k.startswith(name + "/")}
            assert np.array_equal(many["delivered"], one["delivered"]), name
            assert np.array_equal(many["acct"], one["acct"]), name
            for t in range(ROUNDS):
                drift = _drifts({k: v[t] for k, v in many.items()},
                                {k: v[t] for k, v in one.items()})
                print(f"{prefix}{name} round {t}: {drift}")
                assert max(drift.values()) <= 1e-5, (prefix, name, t, drift)


# ---------------------------------------------------------------------------
# (f) the entry points

def test_server_shard_tracks_the_engine_server():
    """``FLServer(engine="shard")`` starts its own one-rank group, records
    ``"shard"`` telemetry that validates, and tracks the engine-backed
    server in own mode: masks, bytes and $ exact, reputation within
    1e-4."""
    fl, topo, data, _ = setup(HEADLINE)
    sink = ListSink()
    assert not dist.is_initialized()
    with FLServer(fl, topo, data, seed=0, device="cpu", engine="shard",
                  telemetry=Telemetry(sink)) as b:
        assert dist.is_initialized() and dist.get_world_size() == 1
        a = FLServer(fl, topo, data, seed=0, device="cpu", engine="jit")
        assert b.engine_resolved == "shard"
        assert isinstance(b._eng, sharded.ShardEngine)
        for t in range(2):
            ma, mb = a.run_round(t), b.run_round(t)
            assert np.array_equal(ma.selected, mb.selected)
            assert (ma.cost, ma.extra["intra_bytes"],
                    ma.extra["cross_bytes"]) == (
                mb.cost, mb.extra["intra_bytes"], mb.extra["cross_bytes"])
            assert rel(mb.reputation, ma.reputation) <= 1e-4
        b.record_eval(1, b.evaluate())
        b.finish_telemetry()
    assert not dist.is_initialized()
    assert validate_events(sink.events) == []
    assert {e["engine"] for e in sink.events if "engine" in e} == {"shard"}
    assert [e["event"] for e in sink.events] == (
        ["run_start"] + ["round", "span"] * 2 + ["eval", "run_end"])


def test_server_ends_only_the_group_it_started():
    """A shard server ends the one-rank group it started on ``close``
    (twice is harmless), ``run_simulation(engine="shard")`` ends its
    server's, and a group the caller started outlives the server."""
    fl, topo, data, _ = setup(HEADLINE)
    srv = FLServer(fl, topo, data, device="cpu", engine="shard")
    assert dist.is_initialized()
    srv.close()
    srv.close()
    assert not dist.is_initialized()
    run_simulation(fl, rounds=1, data=data, device="cpu", engine="shard")
    assert not dist.is_initialized()
    sharded.ensure_group(CPU)
    try:
        with FLServer(fl, topo, data, device="cpu", engine="shard") as srv:
            srv.run_round(0)
        assert dist.is_initialized()
    finally:
        dist.destroy_process_group()


def test_run_simulation_sharded_end_to_end():
    """``run_simulation_sharded`` against ``run_simulation`` on the round
    engine (own mode, one dataset): totals exact, reputation within
    1e-4, one accuracy at the end; its telemetry replays the rounds as
    ``"shard"`` lines that validate; the group it started is ended; zero
    rounds returns the round-zero state."""
    fl, _, data, _ = setup(DEFENSE)
    sink = ListSink()
    got = run_simulation_sharded(fl, rounds=2, data=data, device="cpu",
                                 telemetry=Telemetry(sink), n_devices=1)
    assert not dist.is_initialized()
    want = run_simulation(fl, rounds=2, eval_every=2, data=data,
                          device="cpu", engine="jit")
    assert (got.total_cost, got.intra_bytes, got.cross_bytes) == (
        want.total_cost, want.intra_bytes, want.cross_bytes)
    assert rel(got.reputation, want.reputation) <= 1e-4
    assert got.rounds == [2] and len(got.accuracy) == 1
    assert 0.0 <= got.final_accuracy <= 1.0
    assert np.array_equal(got.malicious, want.malicious)
    assert validate_events(sink.events) == []
    rounds = [e for e in sink.events if e["event"] == "round"]
    assert len(rounds) == 2 and all(e["engine"] == "shard" for e in rounds)
    assert all(e["feat_weights"] is not None for e in rounds)
    assert rounds[-1]["cum_cost"] == got.total_cost
    assert [e["event"] for e in sink.events][-2:] == ["eval", "run_end"]

    sink = ListSink()
    zero = run_simulation_sharded(fl, rounds=0, data=data, device="cpu",
                                  telemetry=Telemetry(sink))
    assert zero.final_accuracy is None and zero.total_cost == 0.0
    assert zero.accuracy == [] and zero.rounds == []
    assert np.array_equal(zero.reputation, np.full(12, 1.0 / 12,
                                                   np.float32))
    assert [e["event"] for e in sink.events] == ["run_start", "run_end"]
    assert not dist.is_initialized()


def test_sharded_entry_points_refuse(monkeypatch):
    """The card by default (no card: ``RuntimeError``), ``n_devices``
    other than the group's size and what the engine refuses raise
    ``ValueError``; a group an entry point started is ended even then."""
    fl, _, data, _ = setup(HEADLINE)
    with pytest.raises(ValueError, match="process group has 1 ranks"):
        run_simulation_sharded(fl, rounds=1, data=data, device="cpu",
                               n_devices=2)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="matrix-shaped"):
        run_simulation_sharded(FLConfig(**{**SMALL, "attack": "min_max"}),
                               rounds=1, data=data, device="cpu")
    assert not dist.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_simulation_sharded(fl, rounds=1, data=data)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FLServer(fl, tmake_topology(fl), data, engine="shard")
    assert not dist.is_initialized()


def test_worker_imports_neither_jax_nor_reference():
    """The spawned ranks' code is the port's alone."""
    import ast
    for node in ast.walk(ast.parse(WORKER.read_text())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module] if isinstance(node, ast.ImportFrom)
                 else [])
        for mod in names:
            assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), mod
