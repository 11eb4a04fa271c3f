"""The port's telemetry (``repro_torch.telemetry``) against the
reference's (``repro.telemetry``): the same raw round outputs give
byte-identical JSONL lines, each package's validator and report CLI read
the other's streams, the sinks hold up, and replayed rounds through both
``FLServer``s — the round engine (``reference_draws``) on the headline
and defense wires, the host loop (``host_reference_draws``) — emit
events that agree field by field: integers, bytes, $, the price
multiplier, the compression ratio and the delivered-mask digest exactly;
the reputation summaries, ``params_l2`` and the feature weights within
1e-4 relative (the replay contract). Then the port on its own: the
untapped step is the step, and ``run_simulation_batch`` streams the
``FLServer`` driver's lines and keeps each seed's run.
"""
import json
import subprocess
import sys
from dataclasses import fields, replace
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from _torch_replay import (SMALL, SMALL_DATA, host_reference_draws,
                           reference_draws)
from repro.configs.base import FLConfig as JFLConfig
from repro.core.fl_types import CloudTopology as JTopology
from repro.federated.server import FLServer as JFLServer
from repro.federated.simulation import make_data as jmake_data
from repro.federated.simulation import make_topology as jmake_topology
from repro.telemetry import ListSink as JListSink
from repro.telemetry import Telemetry as JTelemetry
from repro.telemetry import report as jreport
from repro.telemetry.schema import RunContext as JRunContext
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch import convert, scenarios
from repro_torch.configs.base import FLConfig
from repro_torch.core.fl_types import CloudTopology
from repro_torch.federated import (FLServer, make_data, make_topology,
                                   run_simulation, run_simulation_batch)
from repro_torch.telemetry import (JsonlSink, ListSink, RingBufferSink,
                                   TapSpec, Telemetry, encode, instrument,
                                   stamp, validate_events)
from repro_torch.telemetry import report
from repro_torch.telemetry.schema import RunContext

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
HEADLINE = dict(attack="label_flip", malicious_frac=0.3, compressor="topk",
                compress_ratio=0.1, link_policy="cross_only")
DEFENSE = dict(attack="alie_norm", malicious_frac=0.3,
               trust_features="multi", compressor="qsgd", qsgd_levels=15,
               link_policy="all")
# the fields a replayed round must reproduce exactly, and those held to
# the replay contract's 1e-4 relative
EXACT = ("schema", "event", "run_id", "engine", "method", "attack",
         "scenario", "seed", "t", "n_selected", "n_delivered",
         "n_active_malicious", "intra_bytes", "cross_bytes", "cost",
         "cum_cost", "cum_intra_bytes", "cum_cross_bytes", "price_mult",
         "compression_ratio", "trust_features")
CLOSE = ("rep_mean", "rep_min", "rep_max", "rep_honest_mean",
         "rep_malicious_mean")


def _narrow(data):
    """``data`` with every image cropped to its top-left 8 x 8 pixels: the
    paper's CNN at a narrow width (D = 53,578; the last layer keeps its
    1290 entries), so the reference's round compiles and runs in seconds
    on one core."""
    crop = lambda x: np.ascontiguousarray(x[..., :8, :8, :])
    return replace(data, client_x=crop(data.client_x),
                   ref_x=crop(data.ref_x), test_x=crop(data.test_x))


@pytest.fixture(scope="module")
def datasets():
    """One dataset per package for the module (the same arrays)."""
    jfl, tfl = JFLConfig(**SMALL), FLConfig(**SMALL)
    return (_narrow(jmake_data(jfl, "cifar10", seed=0, **SMALL_DATA)),
            _narrow(make_data(tfl, **SMALL_DATA)))


def _rounds(events):
    return [e for e in events if e["event"] == "round"]


def _close(a, b, tol=1e-4) -> bool:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return bool(np.all(np.abs(a - b) <= tol * np.maximum(np.abs(b), 1e-30)))


def _assert_rounds_agree(port, ref):
    """Round events field by field: EXACT exactly, the float digests
    within 1e-4 relative, nothing else present on one side only."""
    assert len(port) == len(ref) > 0
    for p, r in zip(port, ref):
        assert list(p) == list(r), (list(p), list(r))
        for k in EXACT:
            assert p[k] == r[k], (r["t"], k, p[k], r[k])
        for k in CLOSE:
            assert (p[k] is None) == (r[k] is None), k
            if r[k] is not None:
                assert _close(p[k], r[k]), (r["t"], k, p[k], r[k])
        assert p["digest"]["delivered_sha"] == r["digest"]["delivered_sha"]
        for k in ("params_l2", "rep_l2", "rep_sum"):
            assert _close(p["digest"][k], r["digest"][k]), (r["t"], k)
        assert (p["feat_weights"] is None) == (r["feat_weights"] is None)
        if r["feat_weights"] is not None:
            assert _close(p["feat_weights"], r["feat_weights"]), r["t"]


# ---------------------------------------------------------------------------
# one factory, byte for byte

def _contexts(hierarchical: bool, multi: bool, mults, tel_j, tel_t):
    """A reference and a port RunContext over the same static slice."""
    n_clouds, per_cloud, d = 3, 4, 545_098
    rng = np.random.default_rng(7)
    malicious = np.zeros(n_clouds * per_cloud, bool)
    malicious[[1, 6, 10]] = True
    cp = rng.choice([4.0 * d, 54_514.0 * 6], n_clouds * per_cloud)
    ep = np.array([4.0 * d, 327_086.0, 327_086.0])
    kw = dict(engine="jit", run_id="ctx-s3", method="cost_trustfl",
              attack="alie_norm", seed=3, d_params=d,
              hierarchical=hierarchical, m_selected=6, malicious=malicious,
              client_payload=cp, edge_payload=ep, c_intra=0.01,
              c_cross=0.09, price_multipliers=mults, malice_warmup=1,
              scenario="price_surge" if len(mults) > 1 else None,
              trust_features="multi" if multi else "scalar")
    return (JRunContext(tel_j, topo=JTopology.even(n_clouds, per_cloud),
                        **kw),
            RunContext(tel_t, topo=CloudTopology.even(n_clouds, per_cloud),
                       **kw))


@pytest.mark.parametrize("hierarchical,multi,mults", [
    (False, False, (1.0,)), (True, False, (1.0, 3.0, 1.0, 0.5)),
    (True, True, (1.0,)), (True, True, (1.0, 3.0, 1.0, 0.5))],
    ids=["flat", "scalar-cycle", "multi", "multi-cycle"])
def test_round_lines_byte_identical(hierarchical, multi, mults):
    """The same numpy round outputs (float32 reputation and feature
    weights, ``params_l2`` as a float of a float32) through both
    packages' RunContext: every line's bytes agree — the internal
    float64 accounting at the round's price, the explicit $ and bytes
    override, eval, span and run_end."""
    js, ts = JListSink(), ListSink()
    jctx, tctx = _contexts(hierarchical, multi, mults, JTelemetry(js),
                           Telemetry(ts))
    rng = np.random.default_rng(11)
    for ctx in (jctx, tctx):
        ctx.run_start(rounds=5, config={"a": 1, "b": [0.5, None]})
    for t in range(5):
        delivered = rng.random(12) < 0.6
        rep = rng.random(12).astype(np.float32)
        rep /= rep.sum()
        l2 = float(np.float32(rng.random() * 40))
        fw = (rng.dirichlet(np.ones(4)).astype(np.float32) if multi
              else None)
        explicit = {}
        if t == 3:          # a driver that billed the round itself
            explicit = dict(cost=1.25e-4, intra_bytes=1.5e7,
                            cross_bytes=6.5e5, price_mult=2.0)
        for ctx in (jctx, tctx):
            ctx.round(t, delivered, rep, l2, feat_weights=fw, **explicit)
            ctx.span("round", 0.125, phase="execute", t=t)
    for ctx in (jctx, tctx):
        ctx.eval(4, 0.5)
        ctx.run_end()
    a, b = [encode(e) for e in js.events], [encode(e) for e in ts.events]
    assert len(a) == 1 + 5 * 2 + 2
    assert a == b
    assert validate_events(js.events) == []


@pytest.mark.parametrize("knobs", [{}, HEADLINE, DEFENSE],
                         ids=["default", "headline", "defense"])
def test_run_start_line_byte_identical(knobs):
    """``run_start`` with each package's own FLConfig echoed: one line."""
    lines = []
    for cfg_cls, ctx_cls, topo in (
            (JFLConfig, JRunContext, JTopology.even(3, 4)),
            (FLConfig, RunContext, CloudTopology.even(3, 4))):
        fl = cfg_cls(**SMALL, **knobs)
        sink = ListSink()
        ctx = ctx_cls(sink, engine="host", run_id="r", method="m",
                      attack=fl.attack, seed=0, topo=topo, d_params=10,
                      hierarchical=True, m_selected=6,
                      malicious=np.zeros(12, bool),
                      trust_features=fl.trust_features)
        ctx.run_start(rounds=3, config={f.name: getattr(fl, f.name)
                                        for f in fields(fl)})
        lines.append(encode(sink.events[0]))
    assert lines[0] == lines[1]


def _stream(tmp_path, name, ctx_cls, topo, sink_cls, tel_cls):
    path = tmp_path / f"{name}.jsonl"
    with tel_cls(sink_cls(path)) as tel:
        ctx = ctx_cls(tel, engine="jit", run_id=name, method="m",
                      attack="a", seed=0, topo=topo, d_params=100,
                      hierarchical=True, m_selected=4,
                      malicious=np.array([True, False, False, False]),
                      trust_features="multi")
        ctx.run_start(rounds=2)
        for t in range(2):
            ctx.round(t, np.ones(4, bool), np.full(4, 0.25, np.float32),
                      1.0, feat_weights=np.full(4, 0.25, np.float32))
        ctx.eval(1, 0.5)
        ctx.run_end()
    return path


def test_validators_and_report_cli_read_each_others_streams(tmp_path,
                                                            capsys):
    from repro.telemetry import JsonlSink as JJsonlSink

    paths = [_stream(tmp_path, "ref", JRunContext, JTopology.even(2, 2),
                     JJsonlSink, JTelemetry),
             _stream(tmp_path, "port", RunContext, CloudTopology.even(2, 2),
                     JsonlSink, Telemetry)]
    assert paths[0].read_bytes().replace(b'"ref"', b'"port"') \
        == paths[1].read_bytes()
    bad = tmp_path / "bad.jsonl"
    bad.write_text(paths[1].read_text()
                   + '{"schema":"nope","event":"round"}\n')
    for mod in (report, jreport):
        for path in paths:
            assert validate_events(mod.load_events(path)) == []
            assert mod.main([str(path), "--validate-only"]) == 0
            assert mod.main([str(path)]) == 0
        assert mod.main([str(bad), "--validate-only"]) == 1
    out = capsys.readouterr().out
    assert "ref: cum_cost=$" in out and "port: cum_cost=$" in out
    assert "intra MB" in out
    # the port's CLI as a module, on the reference's stream
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.telemetry.report",
         str(paths[0]), "--validate-only"], capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=120)
    assert cli.returncode == 0, cli.stderr
    assert "5 events, schema OK" in cli.stdout


# ---------------------------------------------------------------------------
# sinks

def test_ring_buffer_is_bounded():
    sink = RingBufferSink(capacity=3)
    for i in range(10):
        sink.emit({"i": i})
    assert sink.capacity == 3
    assert [e["i"] for e in sink.events] == [7, 8, 9]
    with pytest.raises(ValueError):
        RingBufferSink(capacity=0)


def test_jsonl_sink_flushes_per_event_and_survives_exception(tmp_path):
    path = tmp_path / "events.jsonl"
    with pytest.raises(RuntimeError):
        with Telemetry(JsonlSink(path)) as tel:
            tel.emit({"schema": "s", "event": "x", "i": 0})
            tel.emit({"schema": "s", "event": "x", "i": 1})
            # flushed per line: on disk before the sink closes
            assert len(path.read_text().splitlines()) == 2
            raise RuntimeError("mid-run crash")
    assert [json.loads(l)["i"] for l in path.read_text().splitlines()] \
        == [0, 1]
    sink = JsonlSink(tmp_path / "b.jsonl")
    sink.emit({"a": 1})
    sink.close()
    sink.close()                       # idempotent
    with pytest.raises(ValueError):
        sink.emit({"a": 2})


def test_telemetry_close_closes_all_sinks_despite_errors():
    class Boom:
        closed = False

        def emit(self, ev):
            pass

        def close(self):
            self.closed = True
            raise OSError("disk gone")

    a, b = Boom(), Boom()
    with pytest.raises(OSError):
        Telemetry(a, b).close()
    assert a.closed and b.closed


def test_stamp_names_the_host_and_no_card_here():
    s = stamp()
    assert s["torch"] == torch.__version__ and s["python"]
    assert s["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    if not torch.cuda.is_available():
        assert s["device_kind"] is None and s["power_limit"] is None
    json.dumps(s)


# ---------------------------------------------------------------------------
# replayed rounds through both FLServers

def _servers(cfg, engine, datasets):
    jfl, tfl = JFLConfig(**cfg), FLConfig(**cfg)
    jdata, tdata = datasets
    jsink, tsink = JListSink(), ListSink()
    jserver = JFLServer(jfl, jmake_topology(jfl), jdata, engine=engine,
                        telemetry=JTelemetry(jsink))
    tserver = FLServer(tfl, make_topology(tfl), tdata, device="cpu",
                       engine=engine, telemetry=Telemetry(tsink))
    assert jserver.engine_resolved == tserver.engine_resolved == engine
    return jserver, tserver, jsink, tsink


def _finish(jserver, tserver, jsink, tsink):
    for s in (jserver, tserver):
        s.record_eval(1, 0.5)
        s.finish_telemetry()
    assert validate_events(jsink.events) == []
    assert validate_events(tsink.events) == []
    # run_start (config echo, no stamp) is one line in both
    assert encode(tsink.events[0]) == encode(jsink.events[0])
    _assert_rounds_agree(_rounds(tsink.events), _rounds(jsink.events))
    # spans: one a round, the first round "compile+execute"
    phases = [e["phase"] for e in tsink.events if e["event"] == "span"]
    assert phases == [e["phase"] for e in jsink.events
                      if e["event"] == "span"]
    assert phases[0] == "compile+execute" and set(phases[1:]) <= {"execute"}
    end_t, end_j = tsink.events[-1], jsink.events[-1]
    assert end_t["event"] == "run_end"
    assert {k: end_t[k] for k in ("rounds_emitted", "cum_cost",
                                  "cum_intra_bytes", "cum_cross_bytes")} \
        == {k: end_j[k] for k in ("rounds_emitted", "cum_cost",
                                  "cum_intra_bytes", "cum_cross_bytes")}
    assert end_t["cum_cost"] == tserver.cum_cost


@pytest.mark.parametrize("knobs", [HEADLINE, DEFENSE],
                         ids=["headline", "defense"])
def test_engine_loop_events_match_reference(datasets, knobs):
    """The round engine: the port's ``FLServer`` replays the reference
    engine's draws from its initial state, both with telemetry."""
    cfg = {**SMALL, **knobs}
    jserver, tserver, jsink, tsink = _servers(cfg, "jit", datasets)
    js = jserver._eng_state
    tserver._eng_state = convert.round_state_from_numpy(
        {k: np.asarray(v) for k, v in js.params.items()},
        np.asarray(js.rep_ema), np.asarray(js.res_edge), 0, device=CPU,
        res_client=np.asarray(js.res_client),
        feat_sep=np.asarray(js.feat_sep))
    teng = tserver._eng
    steps, ref_steps = teng.schedule(tserver._eng_data)
    noisy = teng.client_wire_noise or teng.edge_wire_noise
    for t in range(2):
        jserver.run_round(t)
        jax.effects_barrier()
        tserver.run_round(t, reference_draws(
            0, t, teng.n, steps, cfg["local_batch"],
            SMALL_DATA["samples_per_client"], ref_steps, cfg["ref_samples"],
            d=teng.d_params if noisy else 0, k=teng.k,
            edge_fold=teng.edge_noise_fold))
    _finish(jserver, tserver, jsink, tsink)
    if knobs is DEFENSE:
        assert all(e["feat_weights"] is not None
                   for e in _rounds(tsink.events))


def test_host_loop_events_match_reference(datasets):
    """The host round loop: the port's replays the reference host loop's
    draws from its initial params, both with telemetry (headline wire)."""
    cfg = {**SMALL, **HEADLINE}
    jserver, tserver, jsink, tsink = _servers(cfg, "host", datasets)
    tserver.params = convert.params_from_numpy(
        {k: np.asarray(v) for k, v in jserver.params.items()}, device=CPU)
    teng = tserver._eng
    steps, ref_steps = teng.schedule(tserver._eng_data)
    for t in range(2):
        jserver.run_round(t)
        tserver.run_round(t, host_reference_draws(
            0, t, teng.n, steps, cfg["local_batch"],
            SMALL_DATA["samples_per_client"], ref_steps,
            cfg["ref_samples"]))
    _finish(jserver, tserver, jsink, tsink)


# ---------------------------------------------------------------------------
# the port on its own

def test_instrument_off_is_the_step_and_on_hands_numpy():
    def step(state, data, t):
        return state + 1, (torch.tensor([t]), torch.tensor(2.0 * t))

    assert instrument(step, None) is step
    assert instrument(step, TapSpec(enabled=False)) is step
    from repro_torch.telemetry import collecting
    got = []
    tapped = instrument(step, TapSpec())
    with collecting(lambda t, out: got.append((t, out))):
        state, out = tapped(0, None, 3)
    assert state == 1 and torch.equal(out[0], torch.tensor([3]))
    assert got[0][0] == 3
    assert isinstance(got[0][1], tuple)
    assert all(isinstance(x, np.ndarray) for x in got[0][1])
    # no consumer installed: the tap is a no-op
    assert tapped(0, None, 1)[0] == 1


def test_batch_streams_the_server_lines_and_keeps_each_seed(datasets):
    """``run_simulation_batch``: one seed streams live through
    ``Engine.run``'s tap, byte for byte the ``FLServer`` driver's round
    lines; two seeds on one shared dataset replay each seed's events
    after the run and give each seed's single-seed totals, reputation and
    accuracy; host-only combinations raise as the reference's do."""
    fl = FLConfig(**SMALL, **HEADLINE)
    data = datasets[1]
    server, live, multi = ListSink(), ListSink(), ListSink()
    run_simulation(fl, rounds=2, eval_every=10, data=data, device="cpu",
                   engine="jit", telemetry=Telemetry(server))
    one = run_simulation_batch(fl, seeds=[0], rounds=2, data=data,
                               device="cpu", telemetry=Telemetry(live))
    two = run_simulation_batch(fl, seeds=[0, 1], rounds=2, data=data,
                               device="cpu", telemetry=Telemetry(multi))
    one1 = run_simulation_batch(fl, seeds=[1], rounds=2, data=data,
                                device="cpu")
    for ev in (server.events, live.events, multi.events):
        assert validate_events(ev) == []
    lines = [encode(e) for e in _rounds(server.events)]
    assert len(lines) == 2
    assert [encode(e) for e in _rounds(live.events)] == lines
    assert [encode(e) for e in _rounds(multi.events)
            if e["seed"] == 0] == lines
    kinds = [e["event"] for e in live.events]
    assert kinds == ["run_start", "round", "round", "span", "eval",
                     "run_end"]
    for s in (0, 1):
        evs = [e["event"] for e in multi.events
               if e["run_id"] == f"cost_trustfl-s{s}"]
        assert evs.count("run_start") == evs.count("run_end") == 1
        assert evs.count("round") == 2
    for single, batched in ((one[0], two[0]), (one1[0], two[1])):
        assert (single.total_cost, single.intra_bytes, single.cross_bytes) \
            == (batched.total_cost, batched.intra_bytes, batched.cross_bytes)
        assert np.array_equal(single.reputation, batched.reputation)
        assert single.final_accuracy == batched.final_accuracy
        assert single.rounds == batched.rounds == [2]
    assert two[0].total_cost == _rounds(server.events)[-1]["cum_cost"]
    with pytest.raises(ValueError):
        run_simulation_batch(fl, seeds=[0], method="median",
                             scenario="dropout", rounds=1, data=data,
                             device="cpu")
    host_hook = scenarios.Scenario("h", "environment",
                                   deliver=scenarios.make_dropout_hook(0.5))
    with pytest.raises(ValueError):
        run_simulation_batch(fl, seeds=[0], scenario=host_hook, rounds=1,
                             data=data, device="cpu")


def test_host_loop_defense_reports_feature_weights(datasets):
    """The host loop under the multi-feature gate: every round event
    carries the round's feature weights; ``params_l2`` is the norm of the
    params after the round."""
    fl = FLConfig(**SMALL, **DEFENSE)
    sink = ListSink()
    server = FLServer(fl, make_topology(fl), datasets[1], device="cpu",
                      engine="host", telemetry=Telemetry(sink))
    server.run_round(0)
    ev = _rounds(sink.events)[0]
    assert ev["engine"] == "host" and ev["trust_features"] == "multi"
    assert len(ev["feat_weights"]) == 4
    assert abs(sum(ev["feat_weights"]) - 1.0) <= 1e-6
    l2 = np.sqrt(sum(float(np.sum(np.square(p.double().numpy())))
                     for p in server.params.values()))
    assert _close(ev["digest"]["params_l2"], l2, 1e-5)


@pytest.mark.parametrize("engine", ["jit", "host"])
def test_trace_capture_holds_the_round_labels(datasets, tmp_path, engine):
    """A ``trace()`` capture of one defense round (every phase runs: the
    attack, the client wire) holds the six ``round.*`` labels, on either
    round loop, and a second capture cannot start inside the first."""
    from repro_torch.telemetry import start_trace, trace

    fl = FLConfig(**SMALL, **DEFENSE)
    server = FLServer(fl, make_topology(fl), datasets[1], device="cpu",
                      engine=engine)
    with trace(str(tmp_path)):
        server.run_round(0)
        with pytest.raises(RuntimeError):
            start_trace(str(tmp_path / "inner"))
    doc = json.loads((tmp_path / "trace.json").read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"round.select", "round.train", "round.attack", "round.compress",
            "round.aggregate", "round.account"} <= names
