"""Server-side orchestration of Algorithm 1: ``FLServer``, a stateful
wrapper over the round engine (``repro_torch.federated.engine``) with
float64 host accounting from each round's delivered mask. ``method``
picks Cost-TrustFL or one of the flat baselines; ``scenario`` adds an
adversary/environment scenario (``repro_torch.scenarios``)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Union

from repro_torch.configs.base import FLConfig
from repro_torch.core.fl_types import CloudTopology, RoundMetrics
from repro_torch.core.reputation import ReputationState
from repro_torch.data.pipeline import FederatedData
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.federated import client as client_mod
from repro_torch.federated import engine as engine_mod
from repro_torch.scenarios import Scenario, get_scenario

ScenarioLike = Union[str, Scenario, None]


def resolve_scenario(scenario: ScenarioLike) -> Optional[Scenario]:
    """A registered scenario's name → the ``Scenario``; else as given."""
    return get_scenario(scenario) if isinstance(scenario, str) else scenario


@dataclass
class FLServer:
    """One server on ``device`` (default ``"cuda"``; raises without a GPU
    unless ``device="cpu"`` is passed). ``scenario`` — a ``Scenario`` or a
    registered name — has its overrides applied to ``flcfg`` (idempotent)
    and its ``jit_hooks`` read by the engine."""
    flcfg: FLConfig
    topo: CloudTopology
    data: FederatedData
    method: str = "cost_trustfl"
    seed: int = 0
    scenario: ScenarioLike = None
    device: DeviceLike = "cuda"

    def __post_init__(self):
        self.scenario = resolve_scenario(self.scenario)
        if self.scenario is not None:
            self.flcfg = self.scenario.apply(self.flcfg)
        fl = self.flcfg
        shape = tuple(self.data.client_x.shape[2:])
        static = engine_mod.static_from(fl, self.topo, self.method,
                                        self.scenario, input_shape=shape,
                                        n_classes=self.data.n_classes)
        self.device = resolve_device(self.device)
        self._eng = engine_mod.Engine(static, self.device)
        self.d_params = self._eng.d_params
        self.malicious = engine_mod.draw_malicious(fl, self.topo.n_clients,
                                                   self.seed)
        self._eng_data = engine_mod.make_client_data(
            fl, self.topo, self.data, self.seed, device=self.device,
            malicious=self.malicious)
        self._eng_state = self._eng.init_state(self.seed)
        self.params = self._eng_state.params
        self.rep = ReputationState(ema=self._eng_state.rep_ema)
        self.cum_cost = 0.0
        self.cum_intra_bytes = 0.0
        self.cum_cross_bytes = 0.0
        self.history: List[RoundMetrics] = []

    def run_round(self, t: int,
                  draws: Optional[engine_mod.RoundDraws] = None
                  ) -> RoundMetrics:
        """One engine round (own-mode randomness unless ``draws`` is
        given), then byte-exact float64 accounting on the host at round
        t's price."""
        state, out = self._eng.step(self._eng_state, self._eng_data, t,
                                    draws)
        self._eng_state = state
        self.params = state.params
        self.rep = ReputationState(ema=state.rep_ema)
        delivered = out.delivered.cpu().numpy()
        cost, intra_b, cross_b = self._eng.host_round_accounting(
            delivered[None], t0=t)[0]
        self.cum_cost += cost
        self.cum_intra_bytes += intra_b
        self.cum_cross_bytes += cross_b
        extra = {"intra_bytes": intra_b, "cross_bytes": cross_b}
        if out.feat_weights.numel():          # trust_features="multi"
            extra["feat_weights"] = out.feat_weights.cpu().numpy()
        metrics = RoundMetrics(round=t, cost=cost, cum_cost=self.cum_cost,
                               selected=delivered,
                               reputation=state.rep_ema.cpu().numpy(),
                               extra=extra)
        self.history.append(metrics)
        return metrics

    @property
    def round_state(self) -> engine_mod.RoundState:
        """The engine state after the last round (read-only use)."""
        return self._eng_state

    def evaluate(self) -> float:
        return client_mod.accuracy(self.params, self.data.test_x,
                                   self.data.test_y)
