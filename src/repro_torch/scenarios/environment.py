"""Environment scenarios: no new update math — they stress the protocol.
Each carries its environment twice: as host hooks, which the host round
loop calls (``FLServer(engine="host")``), and as ``JitHooks`` data, which
the round engine reads.

* ``dropout``      — stragglers: each selected client independently
  fails to deliver with probability 0.3 (at least one always delivers).
* ``intermittent`` — sleeper adversaries: honest for 3 rounds to farm
  EMA reputation (Eq. 9), then sign-flip.
* ``price_surge``  — dynamic egress pricing: ``c_cross`` cycles through
  ×(1, 2, 4, 2), seen by Eq. 10 selection and the round's $.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.cost import CostModel
from repro_torch.scenarios.base import JitHooks, Scenario, register_scenario


def make_dropout_hook(p_drop: float):
    """Delivery mask: drop each selected client with prob ``p_drop``
    (one ``rng.random(N)`` draw of the round's generator); never drop
    everyone."""
    def deliver(server, t, rng, sel):
        sel = np.asarray(sel, bool)
        out = sel & (rng.random(sel.shape[0]) >= p_drop)
        if not out.any() and sel.any():
            out[np.nonzero(sel)[0][0]] = True
        return out
    return deliver


def make_intermittent_hook(warmup: int):
    """Active-malice mask: all-honest before ``warmup``, the server's
    static malicious set afterwards."""
    def malicious_now(server, t):
        if t < warmup:
            return np.zeros_like(server.malicious)
        return server.malicious
    return malicious_now


def make_price_surge_hook(multipliers: Sequence[float]):
    """Round-start hook cycling a ``c_cross`` multiplier schedule: swaps
    ``server.cost_model`` and ``server.unit_costs`` (draws nothing)."""
    mults = tuple(float(m) for m in multipliers)

    def on_round_start(server, t, rng):
        base = server.flcfg
        cm = CostModel(base.c_intra, base.c_cross * mults[t % len(mults)],
                       bytes_per_param=server.cost_model.bytes_per_param)
        server.cost_model = cm
        server.unit_costs = cm.hierarchical_unit_costs(server.topo)
    return on_round_start


DROPOUT = register_scenario(Scenario(
    name="dropout", level="environment",
    description="30% of selected clients never deliver their update",
    overrides=dict(attack="none", malicious_frac=0.0),
    knobs=dict(p_drop=0.3),
    deliver=make_dropout_hook(0.3),
    jit_hooks=JitHooks(p_drop=0.3),
))

INTERMITTENT = register_scenario(Scenario(
    name="intermittent", level="environment",
    description="honest for 3 rounds to farm reputation, then sign-flip",
    overrides=dict(attack="sign_flip", malicious_frac=0.3,
                   attack_scale=1.0),
    knobs=dict(warmup=3, scale=1.0),
    malicious_now=make_intermittent_hook(3),
    jit_hooks=JitHooks(malice_warmup=3),
))

PRICE_SURGE = register_scenario(Scenario(
    name="price_surge", level="environment",
    description="cross-cloud egress price cycles ×(1,2,4,2) per round",
    overrides=dict(attack="none", malicious_frac=0.0),
    knobs=dict(multipliers=(1.0, 2.0, 4.0, 2.0)),
    on_round_start=make_price_surge_hook((1.0, 2.0, 4.0, 2.0)),
    jit_hooks=JitHooks(price_multipliers=(1.0, 2.0, 4.0, 2.0)),
))

ENVIRONMENT_SCENARIOS = (DROPOUT, INTERMITTENT, PRICE_SURGE)
