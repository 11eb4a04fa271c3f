"""End-to-end simulation harness (3 clouds x 30 clients, Dirichlet
non-IID data) driving the port's ``FLServer``: one run
(``run_simulation``), every method on one dataset and scenario
(``compare_methods``), or one configuration over several seeds
(``run_simulation_batch``: ``Engine.run`` per seed)."""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import FLConfig
from repro_torch.core.fl_types import CloudTopology
from repro_torch.data.pipeline import FederatedData, build_federated
from repro_torch.data.synthetic import make_cifar10_like, make_femnist_like
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.federated import client as client_mod
from repro_torch.federated import engine as engine_mod
from repro_torch.federated.server import (FLServer, ScenarioLike,
                                          config_echo, resolve_scenario,
                                          run_context)
from repro_torch.scenarios import Scenario
from repro_torch.telemetry import taps as taps_mod
from repro_torch.telemetry.schema import RunContext
from repro_torch.telemetry.taps import TapSpec


@dataclass
class SimResult:
    method: str
    attack: str
    accuracy: List[float]
    rounds: List[int]
    final_accuracy: Optional[float]   # None when no eval ran (rounds=0)
    total_cost: float
    reputation: Optional[np.ndarray] = None
    malicious: Optional[np.ndarray] = None
    intra_bytes: float = 0.0          # cumulative wire bytes, intra-class
    cross_bytes: float = 0.0          # cumulative wire bytes, cross-cloud
    scenario: Optional[str] = None    # registry name when one was run


def make_topology(flcfg: FLConfig) -> CloudTopology:
    return CloudTopology.even(flcfg.n_clouds, flcfg.clients_per_cloud)


def make_data(flcfg: FLConfig, dataset: str = "cifar10", seed: int = 0,
              n_samples: int = 12000, samples_per_client: int = 96
              ) -> FederatedData:
    topo = make_topology(flcfg)
    ds = (make_cifar10_like(n_samples, seed) if dataset == "cifar10"
          else make_femnist_like(n_samples, seed))
    return build_federated(ds, topo, alpha=flcfg.dirichlet_alpha,
                           samples_per_client=samples_per_client,
                           ref_samples=flcfg.ref_samples, seed=seed)


def _engine_context(telemetry: Any, *, engine_name: str,
                    eng: engine_mod.Engine, flcfg: FLConfig,
                    topo: CloudTopology, method: str,
                    scenario: Optional[Scenario], seed: int,
                    malicious: np.ndarray, rounds: int) -> RunContext:
    """RunContext of a round-engine run driven outside ``FLServer``, with
    ``run_start`` (and its ``rounds``) already emitted."""
    ctx = run_context(telemetry, engine_name=engine_name, eng=eng,
                      flcfg=flcfg, topo=topo, method=method,
                      scenario=scenario, seed=seed, malicious=malicious)
    ctx.run_start(rounds=rounds, config=config_echo(flcfg))
    return ctx


def _replay_rounds(ctx: RunContext, delivered: np.ndarray,
                   reps: np.ndarray, params_l2: np.ndarray,
                   feat_weights: Optional[np.ndarray] = None) -> None:
    """Emit round events from stacked (T, ...) RoundOut arrays (numpy) —
    the post-run path of a run that did not stream."""
    for t in range(len(delivered)):
        ctx.round(t, delivered[t], reps[t], float(params_l2[t]),
                  feat_weights=(feat_weights[t] if feat_weights is not None
                                else None))


def run_simulation(flcfg: FLConfig, *, method: Optional[str] = None,
                   scenario: ScenarioLike = None, dataset: str = "cifar10",
                   rounds: Optional[int] = None, eval_every: int = 5,
                   seed: int = 0, data: Optional[FederatedData] = None,
                   device: DeviceLike = "cuda",
                   engine: str = "auto", telemetry: Any = None,
                   verbose: bool = False) -> SimResult:
    """Run one (method, scenario) simulation on ``device`` (default
    ``"cuda"``; raises without a GPU unless ``device="cpu"`` is passed).
    ``scenario`` — a ``repro_torch.scenarios`` registry name or
    ``Scenario`` — has its FLConfig overrides applied first. ``method``
    defaults to ``flcfg.aggregator``. ``engine`` is forwarded to
    ``FLServer`` (the round loop: ``"auto"``, ``"jit"``, ``"host"``).
    ``telemetry`` — an optional ``repro_torch.telemetry.Telemetry``
    recorder: the server emits run_start / per-round / span events, this
    harness adds eval events and the closing run_end."""
    scenario = resolve_scenario(scenario)
    if scenario is not None:
        flcfg = scenario.apply(flcfg)
    device = resolve_device(device)
    method = flcfg.aggregator if method is None else method
    rounds = rounds if rounds is not None else flcfg.rounds
    topo = make_topology(flcfg)
    data = data if data is not None else make_data(flcfg, dataset, seed)
    server = FLServer(flcfg, topo, data, method=method, seed=seed,
                      scenario=scenario, device=device, engine=engine,
                      telemetry=telemetry)
    accs, ticks = [], []
    for t in range(rounds):
        server.run_round(t)
        if (t + 1) % eval_every == 0 or t == rounds - 1:
            acc = server.evaluate()
            accs.append(acc)
            ticks.append(t + 1)
            server.record_eval(t, acc)
            if verbose:
                print(f"[{method}/{flcfg.attack}] round {t+1:4d} "
                      f"acc={acc:.4f} cum_cost=${server.cum_cost:.4f}")
    server.finish_telemetry()
    return SimResult(method=method, attack=flcfg.attack, accuracy=accs,
                     rounds=ticks,
                     final_accuracy=accs[-1] if accs else None,
                     total_cost=server.cum_cost,
                     reputation=server.rep.ema.cpu().numpy(),
                     malicious=server.malicious,
                     intra_bytes=server.cum_intra_bytes,
                     cross_bytes=server.cum_cross_bytes,
                     scenario=scenario.name if scenario is not None else None)


def run_simulation_batch(flcfg: FLConfig, *, seeds: Sequence[int],
                         method: Optional[str] = None,
                         scenario: ScenarioLike = None,
                         dataset: str = "cifar10",
                         rounds: Optional[int] = None,
                         data: Optional[FederatedData] = None,
                         telemetry: Any = None,
                         device: DeviceLike = "cuda") -> List[SimResult]:
    """One configuration over several seeds on the round engine, each
    seed's rounds one :meth:`Engine.run` on ``device``: today a loop over
    the seeds, one after another on one card (the reference vmaps the
    seeds into one device call; a leading seed axis here is future work).

    Semantics match ``run_simulation`` driven by the engine-backed
    ``FLServer`` (same own-mode draws, so a seed's rounds are the same),
    except that accuracy is evaluated once, after the final round, and
    $ and bytes are the float64 accounting of the delivered masks. Each
    seed gets its own data partition, model init and adversary draw
    unless a shared ``data`` is passed (its samples are then staged on
    the device once). Requires a combination the round engine runs —
    host-hook scenarios and host-only combinations raise ``ValueError``
    (run them through ``run_simulation``).

    ``telemetry``: a single-seed batch streams its round events live,
    through the tap of ``Engine.run`` (byte-identical to the per-round
    ``FLServer`` driver's for the same round outputs); with more seeds
    each seed's events are replayed from its stacked outputs after the
    run, as the reference does."""
    scenario = resolve_scenario(scenario)
    if scenario is not None:
        flcfg = scenario.apply(flcfg)
    device = resolve_device(device)
    method = flcfg.aggregator if method is None else method
    rounds = rounds if rounds is not None else flcfg.rounds
    topo = make_topology(flcfg)
    datas = [data if data is not None else make_data(flcfg, dataset, s)
             for s in seeds]
    static = engine_mod.static_from(
        flcfg, topo, method, scenario,
        input_shape=tuple(datas[0].client_x.shape[2:]),
        n_classes=datas[0].n_classes)
    eng = engine_mod.Engine(static, device)
    mals = [engine_mod.draw_malicious(flcfg, topo.n_clients, s)
            for s in seeds]
    if data is not None:
        # the shared sample arrays on the device ONCE; only the labels
        # (poisoning) and the adversary draw differ per seed
        base = engine_mod.make_client_data(flcfg, topo, data, seeds[0],
                                           device=device, malicious=mals[0])
        dev = [base._replace(
                   client_y=torch.as_tensor(
                       engine_mod.poison_labels(flcfg, data, m, s),
                       dtype=torch.int64, device=device),
                   malicious=torch.as_tensor(m, device=device))
               for m, s in zip(mals, seeds)]
    else:
        dev = [engine_mod.make_client_data(flcfg, topo, d, s, device=device,
                                           malicious=m)
               for d, s, m in zip(datas, seeds, mals)]
    ctxs = None
    if telemetry is not None:
        ctxs = [_engine_context(telemetry, engine_name="jit", eng=eng,
                                flcfg=flcfg, topo=topo, method=method,
                                scenario=scenario, seed=s, malicious=m,
                                rounds=rounds)
                for s, m in zip(seeds, mals)]
    streamed = ctxs is not None and len(seeds) == 1

    t0 = time.perf_counter()
    finals, outs = [], []
    for i, s in enumerate(seeds):
        state = eng.init_state(s)
        if rounds == 0:
            finals.append(state)
            outs.append(None)
        elif streamed:
            ctx = ctxs[0]

            def collect(t, out):
                ctx.round(t, out.delivered, out.rep, float(out.params_l2),
                          feat_weights=(out.feat_weights
                                        if out.feat_weights.size else None))
            with taps_mod.collecting(collect):
                fin, out = eng.run(state, dev[i], rounds,
                                   tap=TapSpec(enabled=True))
            finals.append(fin)
            outs.append(out)
        else:
            fin, out = eng.run(state, dev[i], rounds)
            finals.append(fin)
            outs.append(out)
    if ctxs is not None:
        dt = time.perf_counter() - t0
        for ctx in ctxs:
            ctx.span("engine.run", dt, phase="compile+execute")

    results = []
    for i, s in enumerate(seeds):
        fin = finals[i]
        if rounds == 0:
            acc, ticks, cost, ib, cb = [], [], 0.0, 0.0, 0.0
            rep = fin.rep_ema.cpu().numpy()
        else:
            out = engine_mod.RoundOut(*(x.cpu().numpy() for x in outs[i]))
            acc = [client_mod.accuracy(fin.params, datas[i].test_x,
                                       datas[i].test_y)]
            ticks = [rounds]
            # byte-exact float64 accounting from the delivered masks —
            # the same reduction the per-round FLServer driver performs
            rows = eng.host_round_accounting(out.delivered)
            cost, ib, cb = (float(rows[:, 0].sum()), float(rows[:, 1].sum()),
                            float(rows[:, 2].sum()))
            rep = out.rep[-1]
        if ctxs is not None:
            ctx = ctxs[i]
            if rounds > 0 and not streamed:
                _replay_rounds(ctx, out.delivered, out.rep, out.params_l2,
                               out.feat_weights if out.feat_weights.shape[-1]
                               else None)
            if acc:
                ctx.eval(rounds - 1, float(acc[0]))
            ctx.run_end()
        results.append(SimResult(
            method=method, attack=flcfg.attack, accuracy=acc, rounds=ticks,
            final_accuracy=acc[-1] if acc else None, total_cost=cost,
            reputation=np.array(rep), malicious=mals[i],
            intra_bytes=ib, cross_bytes=cb,
            scenario=scenario.name if scenario is not None else None))
    return results


def compare_methods(flcfg: FLConfig, methods: List[str], *,
                    scenario: ScenarioLike = None,
                    dataset: str = "cifar10", rounds: int = 30,
                    seed: int = 0, device: DeviceLike = "cuda",
                    engine: str = "auto") -> Dict[str, SimResult]:
    """Run every method on ONE dataset and scenario, so comparisons are
    like for like (one data partition, one set of scenario hooks). The
    scenario's overrides are applied before the data are made, since
    they may change the partition. ``engine`` is forwarded to every
    server."""
    scenario = resolve_scenario(scenario)
    if scenario is not None:
        flcfg = scenario.apply(flcfg)
    data = make_data(flcfg, dataset, seed)
    return {m: run_simulation(flcfg, method=m, scenario=scenario,
                              dataset=dataset, rounds=rounds, seed=seed,
                              data=data, device=device, engine=engine)
            for m in methods}
