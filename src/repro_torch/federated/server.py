"""Server-side orchestration of Algorithm 1: ``FLServer``, a stateful
wrapper over the round engine (``repro_torch.federated.engine``) with
float64 host accounting from each round's delivered mask."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

from repro_torch.configs.base import FLConfig
from repro_torch.core.fl_types import CloudTopology, RoundMetrics
from repro_torch.core.reputation import ReputationState
from repro_torch.data.pipeline import FederatedData
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.federated import client as client_mod
from repro_torch.federated import engine as engine_mod


def refuse_scenario(scenario: Any) -> None:
    if scenario is not None:
        raise NotImplementedError(
            "scenarios and their hooks (dropout, malice warmup, price "
            "schedules) are not ported yet: ROADMAP queue A item 5")


@dataclass
class FLServer:
    """One Cost-TrustFL server on ``device`` (default ``"cuda"``; raises
    without a GPU unless ``device="cpu"`` is passed)."""
    flcfg: FLConfig
    topo: CloudTopology
    data: FederatedData
    method: str = "cost_trustfl"
    seed: int = 0
    scenario: Optional[Any] = None
    device: DeviceLike = "cuda"

    def __post_init__(self):
        refuse_scenario(self.scenario)
        self.device = resolve_device(self.device)
        fl = self.flcfg
        shape = tuple(self.data.client_x.shape[2:])
        static = engine_mod.static_from(fl, self.topo, self.method,
                                        input_shape=shape,
                                        n_classes=self.data.n_classes)
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
        given), then byte-exact float64 accounting on the host."""
        state, out = self._eng.step(self._eng_state, self._eng_data, t,
                                    draws)
        self._eng_state = state
        self.params = state.params
        self.rep = ReputationState(ema=state.rep_ema)
        delivered = out.delivered.cpu().numpy()
        cost, intra_b, cross_b = self._eng.host_round_accounting(
            delivered[None])[0]
        self.cum_cost += cost
        self.cum_intra_bytes += intra_b
        self.cum_cross_bytes += cross_b
        metrics = RoundMetrics(round=t, cost=cost, cum_cost=self.cum_cost,
                               selected=delivered,
                               reputation=state.rep_ema.cpu().numpy(),
                               extra={"intra_bytes": intra_b,
                                      "cross_bytes": cross_b})
        self.history.append(metrics)
        return metrics

    def evaluate(self) -> float:
        return client_mod.accuracy(self.params, self.data.test_x,
                                   self.data.test_y)
