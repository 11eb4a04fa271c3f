"""Environment scenarios: no new update math — they stress the protocol
through the round engine's ``JitHooks``.

* ``dropout``      — stragglers: each selected client independently
  fails to deliver with probability 0.3 (at least one always delivers).
* ``intermittent`` — sleeper adversaries: honest for 3 rounds to farm
  EMA reputation (Eq. 9), then sign-flip.
* ``price_surge``  — dynamic egress pricing: ``c_cross`` cycles through
  ×(1, 2, 4, 2), seen by Eq. 10 selection and the round's $.
"""
from __future__ import annotations

from repro_torch.scenarios.base import JitHooks, Scenario, register_scenario

DROPOUT = register_scenario(Scenario(
    name="dropout", level="environment",
    description="30% of selected clients never deliver their update",
    overrides=dict(attack="none", malicious_frac=0.0),
    knobs=dict(p_drop=0.3),
    jit_hooks=JitHooks(p_drop=0.3),
))

INTERMITTENT = register_scenario(Scenario(
    name="intermittent", level="environment",
    description="honest for 3 rounds to farm reputation, then sign-flip",
    overrides=dict(attack="sign_flip", malicious_frac=0.3,
                   attack_scale=1.0),
    knobs=dict(warmup=3, scale=1.0),
    jit_hooks=JitHooks(malice_warmup=3),
))

PRICE_SURGE = register_scenario(Scenario(
    name="price_surge", level="environment",
    description="cross-cloud egress price cycles ×(1,2,4,2) per round",
    overrides=dict(attack="none", malicious_frac=0.0),
    knobs=dict(multipliers=(1.0, 2.0, 4.0, 2.0)),
    jit_hooks=JitHooks(price_multipliers=(1.0, 2.0, 4.0, 2.0)),
))

ENVIRONMENT_SCENARIOS = (DROPOUT, INTERMITTENT, PRICE_SURGE)
