"""End-to-end simulation harness (3 clouds x 30 clients, Dirichlet
non-IID data) driving the port's ``FLServer``: one run
(``run_simulation``) or every method on one dataset and scenario
(``compare_methods``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs.base import FLConfig
from repro_torch.core.fl_types import CloudTopology
from repro_torch.data.pipeline import FederatedData, build_federated
from repro_torch.data.synthetic import make_cifar10_like, make_femnist_like
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.federated.server import (FLServer, ScenarioLike,
                                          resolve_scenario)


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


def run_simulation(flcfg: FLConfig, *, method: Optional[str] = None,
                   scenario: ScenarioLike = None, dataset: str = "cifar10",
                   rounds: Optional[int] = None, eval_every: int = 5,
                   seed: int = 0, data: Optional[FederatedData] = None,
                   device: DeviceLike = "cuda",
                   engine: str = "auto") -> SimResult:
    """Run one (method, scenario) simulation on ``device`` (default
    ``"cuda"``; raises without a GPU unless ``device="cpu"`` is passed).
    ``scenario`` — a ``repro_torch.scenarios`` registry name or
    ``Scenario`` — has its FLConfig overrides applied first. ``method``
    defaults to ``flcfg.aggregator``. ``engine`` is forwarded to
    ``FLServer`` (the round loop: ``"auto"``, ``"jit"``, ``"host"``)."""
    scenario = resolve_scenario(scenario)
    if scenario is not None:
        flcfg = scenario.apply(flcfg)
    device = resolve_device(device)
    method = flcfg.aggregator if method is None else method
    rounds = rounds if rounds is not None else flcfg.rounds
    topo = make_topology(flcfg)
    data = data if data is not None else make_data(flcfg, dataset, seed)
    server = FLServer(flcfg, topo, data, method=method, seed=seed,
                      scenario=scenario, device=device, engine=engine)
    accs, ticks = [], []
    for t in range(rounds):
        server.run_round(t)
        if (t + 1) % eval_every == 0 or t == rounds - 1:
            acc = server.evaluate()
            accs.append(acc)
            ticks.append(t + 1)
    return SimResult(method=method, attack=flcfg.attack, accuracy=accs,
                     rounds=ticks,
                     final_accuracy=accs[-1] if accs else None,
                     total_cost=server.cum_cost,
                     reputation=server.rep.ema.cpu().numpy(),
                     malicious=server.malicious,
                     intra_bytes=server.cum_intra_bytes,
                     cross_bytes=server.cum_cross_bytes,
                     scenario=scenario.name if scenario is not None else None)


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
