"""Server-side orchestration of Algorithm 1: ``FLServer``, one server per
method (Cost-TrustFL or a flat baseline) with an optional adversary /
environment scenario (``repro_torch.scenarios``), over one of three round
loops (``engine``, routed by ``engine.resolve_engine``):

* ``"jit"`` — the round engine (``repro_torch.federated.engine``): each
  ``run_round`` is one ``Engine.step`` on a ``RoundState``, then float64
  accounting on the host from the delivered mask;
* ``"shard"`` — the mesh-sharded engine (``federated.sharded``): the same
  per-round loop over ``ShardEngine.step``, this rank's client block of a
  ``torch.distributed`` group (a one-rank group is started when none is
  initialized);
* ``"host"`` — the host round loop, the reference's protocol
  implementation (``repro/federated/server.py:_run_round_host``) and the
  only loop for scenarios with host hooks and no ``jit_hooks`` and for
  dropout under Krum, trimmed mean and median. "Host" names the
  Python-driven loop, not the CPU: its tensors live on ``device``. Only
  the selection and delivery masks (numpy, from the round's
  ``np.random.Generator``) and the float64 $ and byte accounting run on
  the host; Cost-TrustFL aggregates through the host twin
  ``core.aggregation.cost_trustfl_aggregate`` (the fused ``trust_stage``
  kernel and segmented ``weighted_agg``), and the wires are the round
  engine's own (``Engine.client_wire``, ``Engine.edge_wire``).
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Any, Callable, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch.configs.base import FLConfig
from repro_torch.core import robust
from repro_torch.core.aggregation import cost_trustfl_aggregate
from repro_torch.core.attacks import (NOISY_ATTACKS, UPDATE_ATTACKS,
                                      apply_update_attack)
from repro_torch.core.cost import CostModel
from repro_torch.core.fl_types import CloudTopology, RoundMetrics
from repro_torch.core.reputation import ReputationState
from repro_torch.core.selection import exploration_quota, select_clients_host
from repro_torch.data.pipeline import FederatedData
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.federated import client as client_mod
from repro_torch.federated import engine as engine_mod
from repro_torch.scenarios import Scenario, get_scenario
from repro_torch.telemetry import spans
from repro_torch.telemetry.schema import RunContext

Tensor = torch.Tensor
ScenarioLike = Union[str, Scenario, None]


def resolve_scenario(scenario: ScenarioLike) -> Optional[Scenario]:
    """A registered scenario's name → the ``Scenario``; else as given."""
    return get_scenario(scenario) if isinstance(scenario, str) else scenario


def config_echo(flcfg: FLConfig) -> dict:
    """``run_start``'s config: every FLConfig field, in field order."""
    return {f.name: getattr(flcfg, f.name) for f in fields(flcfg)}


def run_context(telemetry: Any, *, engine_name: str, eng: Any,
                flcfg: FLConfig, topo: CloudTopology, method: str,
                scenario: Optional[Scenario], seed: int,
                malicious: np.ndarray,
                run_id: Optional[str] = None) -> RunContext:
    """The event factory of one run, described as the reference's
    drivers describe it: the round's static slice from ``eng`` (the
    hierarchy, the selected count, the exact wire payloads), the price
    schedule and malice warmup from ``scenario``'s hooks (``eng``: an
    ``Engine`` or a ``ShardEngine``); ``run_id``
    defaults to ``"<method>-s<seed>"``."""
    h = engine_mod.hooks_of(scenario)
    return RunContext(
        telemetry, engine=engine_name,
        run_id=run_id if run_id is not None else f"{method}-s{seed}",
        method=method, attack=flcfg.attack, seed=seed, topo=topo,
        d_params=eng.d_params, hierarchical=eng.hier,
        m_selected=eng.m_total, malicious=malicious,
        client_payload=eng.client_payload, edge_payload=eng.edge_payload,
        c_intra=flcfg.c_intra, c_cross=flcfg.c_cross,
        price_multipliers=h.price_multipliers,
        malice_warmup=h.malice_warmup,
        scenario=scenario.name if scenario is not None else None,
        trust_features=flcfg.trust_features)


class HostDraws(NamedTuple):
    """One host-loop round's tensor randomness (selection and delivery
    come from the round's numpy generator). ``None`` in an optional field
    means "draw in own mode when needed"."""
    client_idx: Tensor           # (N, steps, batch) minibatch indices, row = client id
    ref_idx: Tensor              # (ref_steps, REF_BATCH), shared by clouds
    client_noise: Optional[Tensor] = None   # (N, D) U[0,1), client wire, row = client id
    edge_noise: Optional[Tensor] = None     # (K, D) U[0,1), edge wire, row = cloud
    attack_noise: Optional[Tensor] = None   # (m, D) N(0,1), gaussian attack, row = delivered row


@dataclass
class FLServer:
    """One server on ``device`` (default ``"cuda"``; raises without a GPU
    unless ``device="cpu"`` is passed). ``scenario`` — a ``Scenario`` or a
    registered name — has its overrides applied to ``flcfg``
    (idempotent). ``engine``: ``"auto"`` (the round engine where it can
    run the combination, else the host loop; the sharded engine only
    with more than one rank at dense participation), ``"jit"`` (the
    round engine; ``ValueError`` where it cannot), ``"host"`` (the host
    loop) or ``"shard"`` (the mesh-sharded engine over the default
    process group, started at one rank when none is initialized;
    ``ValueError`` with the reason where it cannot); the loop taken is
    ``engine_resolved``. Under ``"shard"`` the telemetry is recorded by
    the group's rank 0, and a group the server started is ended by
    :meth:`close` (or on leaving ``with FLServer(...)``).

    ``telemetry`` — an optional recorder (``repro_torch.telemetry.
    Telemetry`` or any object with ``emit(dict)``): ``run_start`` on
    construction, a ``round`` event and a ``span`` per ``run_round``
    (the reference's events, byte for byte given the same round
    outputs); ``run_id`` defaults to ``"<method>-s<seed>"``. Without
    one, a round reads nothing more from the device."""
    flcfg: FLConfig
    topo: CloudTopology
    data: FederatedData
    method: str = "cost_trustfl"
    seed: int = 0
    scenario: ScenarioLike = None
    device: DeviceLike = "cuda"
    engine: str = "auto"
    telemetry: Optional[Any] = None
    run_id: Optional[str] = None

    def __post_init__(self):
        self.scenario = resolve_scenario(self.scenario)
        if self.scenario is not None:
            self.flcfg = self.scenario.apply(self.flcfg)
        fl = self.flcfg
        self.engine_resolved = engine_mod.resolve_engine(
            self.engine, fl, self.topo, self.method, self.scenario)
        host = self.engine_resolved == "host"
        shard = self.engine_resolved == "shard"
        self.device = resolve_device(self.device)
        self._own_group = False
        if shard:
            from repro_torch.federated import sharded as sharded_mod
            self._own_group = sharded_mod.ensure_group(self.device)
            try:
                self._eng = sharded_mod.engine_for(
                    fl, self.topo, self.data, self.method, self.scenario,
                    device=self.device)
            except BaseException:
                self.close()
                raise
        else:
            # the host loop applies the scenario itself (its hooks), so
            # its Engine — the wires, the payloads and the own-mode
            # streams — is built without one
            static = engine_mod.static_from(
                fl, self.topo, self.method, None if host else self.scenario,
                input_shape=tuple(self.data.client_x.shape[2:]),
                n_classes=self.data.n_classes)
            self._eng = engine_mod.Engine(static, self.device)
        self.d_params = self._eng.d_params
        self.malicious = engine_mod.draw_malicious(fl, self.topo.n_clients,
                                                   self.seed)
        self._eng_data = engine_mod.make_client_data(
            fl, self.topo, self.data, self.seed, device=self.device,
            malicious=self.malicious)
        if shard:
            self._eng_data = self._eng.stage_data(self._eng_data)
        # Eq. 10 sees the hierarchical marginal cost; a host hook may swap
        # both for the round (price surge)
        self.cost_model = CostModel(fl.c_intra, fl.c_cross)
        self.unit_costs = self.cost_model.hierarchical_unit_costs(self.topo)
        self.cum_cost = 0.0
        self.cum_intra_bytes = 0.0
        self.cum_cross_bytes = 0.0
        self.history: List[RoundMetrics] = []
        if host:
            self._eng_state = None
            self.params = self._eng.init_params(self.seed)
            self.rep = ReputationState.init(self.topo.n_clients,
                                            device=self.device)
            self._ll_idx = torch.as_tensor(
                engine_mod.last_layer_index(self._eng.shapes),
                device=self.device)
            # created on first use: (N, D) client uplinks, (K, D) edge
            # uplinks; the separability EMA and the last round's mixing
            # weights under trust_features="multi"
            self._res_client: Optional[Tensor] = None
            self._res_edge: Optional[Tensor] = None
            self._feat_sep: Optional[Tensor] = None
            self._feat_weights: Optional[Tensor] = None
        else:
            self._eng_state = self._eng.init_state(self.seed)
            self.params = self._eng_state.params
            self.rep = ReputationState(ema=self._eng_state.rep_ema)
        self._stepped = False             # the first round builds kernels
        self._telemetry_ctx: Optional[RunContext] = None
        if self.telemetry is not None and (not shard
                                           or self._eng.rank == 0):
            self._telemetry_ctx = run_context(
                self.telemetry, engine_name=self.engine_resolved,
                eng=self._eng, flcfg=fl, topo=self.topo, method=self.method,
                scenario=self.scenario, seed=self.seed,
                malicious=self.malicious, run_id=self.run_id)
            self._telemetry_ctx.run_start(config=config_echo(fl))

    def run_round(self, t: int,
                  draws: Union[engine_mod.RoundDraws, HostDraws, None] = None
                  ) -> RoundMetrics:
        """One round of the resolved loop (own-mode randomness unless
        ``draws`` is given: a ``RoundDraws`` for the engine, a
        ``HostDraws`` for the host loop), then byte-exact float64
        accounting on the host at round t's price. With telemetry, the
        round runs inside a ``"round"`` span (phase ``"compile+execute"``
        on the first round, which includes the kernels' build at first
        use, ``"execute"`` after) and emits its ``round`` event."""
        run = (self._run_round_host if self.engine_resolved == "host"
               else self._run_round_engine)
        ctx = self._telemetry_ctx
        if ctx is None:
            return run(t, draws)
        phase = "execute" if self._stepped else "compile+execute"
        with spans.span("round", ctx, phase=phase, t=t):
            metrics = run(t, draws)
        self._stepped = True
        return metrics

    def _run_round_engine(self, t: int,
                          draws: Optional[engine_mod.RoundDraws]
                          ) -> RoundMetrics:
        state, out = self._eng.step(self._eng_state, self._eng_data, t,
                                    draws)
        self._eng_state = state
        self.params = state.params
        self.rep = ReputationState(ema=state.rep_ema)
        delivered = out.delivered.cpu().numpy()
        cost, intra_b, cross_b = self._eng.host_round_accounting(
            delivered[None], t0=t)[0]
        return self._record(t, delivered, cost, intra_b, cross_b,
                            out.feat_weights if out.feat_weights.numel()
                            else None, out.params_l2)

    def _record(self, t: int, delivered: np.ndarray, cost: float,
                intra_b: float, cross_b: float,
                feat_weights: Optional[Tensor],
                params_l2: Optional[Tensor] = None) -> RoundMetrics:
        """Book the round (float64 totals, ``history``) and, with
        telemetry, emit its event: the reference's raw inputs — the
        reputation as float32 numpy, ``params_l2`` (default: computed
        here from ``self.params``) as ``float()`` of its float32 value —
        and this round's explicit $ and bytes."""
        self.cum_cost += cost
        self.cum_intra_bytes += intra_b
        self.cum_cross_bytes += cross_b
        extra = {"intra_bytes": intra_b, "cross_bytes": cross_b}
        fw = None
        if feat_weights is not None:              # trust_features="multi"
            fw = extra["feat_weights"] = feat_weights.cpu().numpy()
        metrics = RoundMetrics(round=t, cost=cost, cum_cost=self.cum_cost,
                               selected=delivered,
                               reputation=self.rep.ema.cpu().numpy(),
                               extra=extra)
        if self._telemetry_ctx is not None:
            if params_l2 is None:
                params_l2 = engine_mod.tree_l2(self.params)
            self._telemetry_ctx.round(
                t, delivered, metrics.reputation, float(params_l2),
                cost=float(cost), intra_bytes=float(intra_b),
                cross_bytes=float(cross_b), feat_weights=fw)
        self.history.append(metrics)
        return metrics

    # -- the host round loop ---------------------------------------------------
    def draws(self, t: int, full_noise: bool = False) -> HostDraws:
        """The host loop's own-mode round-t draws, from the round engine's
        ``torch.Generator`` streams seeded from ``seed·7919 + t`` on this
        device. The wire noise is drawn in the round for the delivered
        senders only; ``full_noise=True`` materializes it for every
        client and cloud now (the same streams) — for running one set of
        draws on two devices."""
        d = self._eng.draws(self.seed, t, self._eng_data,
                            full_noise=full_noise)
        return HostDraws(d.client_idx, d.ref_idx, d.client_noise,
                         d.edge_noise)

    def _select(self, rng: np.random.Generator) -> np.ndarray:
        """(N,) bool: Eq. 10 with the exploration quota (Cost-TrustFL,
        ``standard_normal(N)`` tie-break) or ``rng.choice`` of m (flat)."""
        fl, n = self.flcfg, self.topo.n_clients
        if self.method == "cost_trustfl":
            return select_clients_host(
                self.rep.ema.cpu().numpy(), self.unit_costs,
                fl.clients_per_round,
                per_cloud_min=exploration_quota(fl.cost_lambda),
                cloud_of=self.topo.cloud_of, cost_lambda=fl.cost_lambda,
                rng=rng)
        sel = np.zeros(n, bool)
        sel[rng.choice(n, fl.clients_per_round, replace=False)] = True
        return sel

    def _reference_updates(self, draws: HostDraws) -> Tensor:
        """(K, D) per-cloud reference updates; every cloud trains on one
        shared minibatch schedule, as the reference's one shared key."""
        cd = self._eng_data
        idx = draws.ref_idx.long()[None].expand(self.topo.n_clouds, -1, -1)
        return engine_mod.ravel_rows(client_mod.local_train(
            self.params, cd.ref_x, cd.ref_y, idx, lr=self.flcfg.lr))

    def _edge_transform(self, draws: HostDraws, active: Tensor, t: int
                        ) -> Optional[Callable[[Tensor], Tensor]]:
        """The edge→global wire as ``cost_trustfl_aggregate``'s
        ``cloud_transform``: ``Engine.edge_wire`` with this loop's
        residual buffer. Clouds with no delivered client (``active``
        (K, 1) False) pass through and keep their residual
        (``round_bytes`` bills them nothing)."""
        eng = self._eng
        if not eng.edge_wire_active:
            return None

        def transform(cloud_aggs: Tensor) -> Tensor:
            if self._res_edge is None:
                self._res_edge = torch.zeros_like(cloud_aggs)
            noise = None
            if eng.edge_wire_noise:
                noise = (draws.edge_noise if draws.edge_noise is not None
                         else eng.edge_noise(self.seed, t))
            out, self._res_edge = eng.edge_wire(cloud_aggs, self._res_edge,
                                                active, noise)
            return out
        return transform

    def _run_round_host(self, t: int, draws: Optional[HostDraws]
                        ) -> RoundMetrics:
        """One host-loop round, its phases under the round engine's
        profiler labels (``round.select`` ... ``round.account``)."""
        eng, fl, dev = self._eng, self.flcfg, self.device
        n = self.topo.n_clients
        with record_function("round.select"):
            rng = np.random.default_rng(self.seed * 100003 + t)
            sc = self.scenario
            if sc is not None:
                # environment mutation (e.g. egress pricing) BEFORE
                # selection, so Eq. 10 and this round's $ see the same
                # prices
                sc.round_start(self, t, rng)
            sel = self._select(rng)
            if sc is not None:
                # dropped clients neither train nor put bytes on the wire
                sel = np.asarray(sc.delivered(self, t, rng, sel), bool)
            sel_ix = np.nonzero(sel)[0]
            malicious = (self.malicious if sc is None
                         else np.asarray(sc.active_malicious(self, t)))
            # the round's host masks go to the device here, before its
            # first launch: a copy from pageable host memory waits for the
            # stream to drain, which mid-round would stall the launches
            # behind it
            sel_idx = torch.as_tensor(sel_ix, device=dev)
            on_dev = dict(
                selected=torch.as_tensor(sel, device=dev),
                malicious=torch.as_tensor(malicious[sel_ix], device=dev),
                active=torch.as_tensor(np.bincount(
                    self.topo.cloud_of[sel], minlength=self.topo.n_clouds)
                    > 0, device=dev)[:, None])
            if draws is None:
                draws = self.draws(t)
            draws = HostDraws(*(None if x is None
                                else torch.as_tensor(x, device=dev)
                                for x in draws))

        # local training of the delivered clients only
        with record_function("round.train"):
            cd = self._eng_data
            flat_sel = engine_mod.ravel_rows(client_mod.local_train(
                self.params, cd.client_x[sel_idx], cd.client_y[sel_idx],
                draws.client_idx[sel_idx].long(), lr=fl.lr))    # (m, D)

        # the update attack on the round's ACTIVE malicious clients
        with record_function("round.attack"):
            if UPDATE_ATTACKS[fl.attack] is not None:
                noise = draws.attack_noise
                if fl.attack in NOISY_ATTACKS and noise is None:
                    noise = eng.attack_noise(self.seed, t, len(sel_ix))
                flat_sel = apply_update_attack(
                    fl.attack, flat_sel, on_dev["malicious"], noise,
                    sigma=fl.gaussian_sigma, scale=fl.attack_scale,
                    z=fl.attack_z)

        # the client uplink wire, after the (sender-side) attack; QSGD
        # noise per sender by global client id
        if eng.client_wire_active:
            with record_function("round.compress"):
                if self._res_client is None:
                    self._res_client = torch.zeros(n, self.d_params,
                                                   device=dev)
                noise = None
                if eng.client_wire_noise:
                    noise = (draws.client_noise[sel_idx]
                             if draws.client_noise is not None
                             else eng.client_noise(self.seed, t, sel_ix))
                flat_sel = eng.client_wire(
                    flat_sel, self._res_client, sel_idx,
                    torch.ones(len(sel_ix), dtype=torch.bool, device=dev),
                    noise)

        with record_function("round.aggregate"):
            update, hier = self._aggregate(flat_sel, sel_idx, on_dev, draws,
                                           t)
            # w <- w - eta * g
            delta = engine_mod.unflatten_like(update * fl.server_lr,
                                              self.params)
            self.params = {k: self.params[k] - delta[k] for k in self.params}

        with record_function("round.account"):
            # float64 accounting at THIS round's prices (a hook may swap
            # them)
            kw = dict(hierarchical=hier, client_payload=eng.client_payload,
                      edge_payload=eng.edge_payload)
            intra_b, cross_b = self.cost_model.round_bytes(
                self.topo, sel, self.d_params, **kw)
            cost = self.cost_model.round_cost(self.topo, sel, self.d_params,
                                              **kw)
            return self._record(t, sel, cost, intra_b, cross_b,
                                self._feat_weights if hier else None)

    def _aggregate(self, flat_sel: Tensor, sel_idx: Tensor, on_dev: dict,
                   draws: HostDraws, t: int) -> Tuple[Tensor, bool]:
        """(update, hierarchical) from the delivered rows ``flat_sel``
        (``on_dev``: the round's masks on the device)."""
        fl = self.flcfg
        method = self.method
        if method == "cost_trustfl":
            n, dev = self.topo.n_clients, self.device
            # the trust path's last layer is taken from the attacked and
            # compressed rows, then both scatter to (N, ·), zero elsewhere
            flat = torch.zeros(n, self.d_params, device=dev).index_copy_(
                0, sel_idx, flat_sel)
            ll = torch.zeros(n, len(self._ll_idx), device=dev).index_copy_(
                0, sel_idx, flat_sel[:, self._ll_idx])
            ref_flat = self._reference_updates(draws)
            res = cost_trustfl_aggregate(
                flat, ll, ref_flat, ref_flat[:, self._ll_idx],
                self._eng.cloud_of, on_dev["selected"], self.rep,
                gamma=fl.ema_gamma,
                cloud_transform=self._edge_transform(draws,
                                                     on_dev["active"], t),
                trust_features=fl.trust_features, feat_sep=self._feat_sep)
            self.rep = res.reputation
            self._feat_weights = res.feat_weights
            if res.feat_sep is not None:
                self._feat_sep = res.feat_sep
            return res.update, True
        u = flat_sel                      # the delivered rows, ascending id
        m = u.shape[0]
        if method == "fedavg":
            return robust.fedavg(u), False
        if method == "krum":
            f = int(fl.malicious_frac * m)
            return robust.krum(u, f, multi=max(1, m - f - 2)), False
        if method == "trimmed_mean":
            return robust.trimmed_mean(u, trim_frac=fl.malicious_frac / 2), \
                False
        if method == "median":
            return robust.coordinate_median(u), False
        if method == "fltrust":
            ref = torch.mean(self._reference_updates(draws), dim=0)
            return robust.fltrust(u, ref), False
        raise ValueError(method)

    # -------------------------------------------------------------------------
    @property
    def round_state(self) -> Optional[engine_mod.RoundState]:
        """The round engine's state after the last round (read-only use);
        None under the host loop."""
        return self._eng_state

    def evaluate(self) -> float:
        return client_mod.accuracy(self.params, self.data.test_x,
                                   self.data.test_y)

    # -- telemetry hooks (no-ops when no recorder is attached) ------------------
    def record_eval(self, t: int, accuracy: float,
                    loss: Optional[float] = None) -> None:
        if self._telemetry_ctx is not None:
            self._telemetry_ctx.eval(t, accuracy, loss)

    def finish_telemetry(self) -> None:
        if self._telemetry_ctx is not None:
            self._telemetry_ctx.run_end()

    def close(self) -> None:
        """End the one-rank process group this server started under
        ``engine="shard"`` (a group the caller started is left alone);
        idempotent, and a no-op for the other round loops. The server
        is also a context manager that closes on exit."""
        if self._own_group:
            self._own_group = False
            dist.destroy_process_group()

    def __enter__(self) -> "FLServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
