"""Adaptive update-level adversaries (out-of-paper extensions). Each
scenario names an attack of ``repro_torch.core.attacks.UPDATE_ATTACKS``;
the sleeper carries its warmup as a host hook and as
``JitHooks(malice_warmup=2)``."""
from __future__ import annotations

from repro_torch.scenarios.base import JitHooks, Scenario, register_scenario
from repro_torch.scenarios.environment import make_intermittent_hook

ALIE = register_scenario(Scenario(
    name="alie", level="adaptive",
    description="a-little-is-enough: hide at mean − z·std of honest rows",
    overrides=dict(attack="alie", malicious_frac=0.3, attack_z=1.0),
    knobs=dict(z=1.0),
))

# reputation-aware ALIE variants: both target the trust evaluator itself
ALIE_NORM = register_scenario(Scenario(
    name="alie_norm", level="adaptive",
    description="ALIE point rescaled to the honest median norm, so the "
                "Eq. 7 norm damp reads attackers as typical",
    overrides=dict(attack="alie_norm", malicious_frac=0.3, attack_z=1.0),
    knobs=dict(z=1.0),
))

ALIE_SLEEPER = register_scenario(Scenario(
    name="alie_sleeper", level="adaptive",
    description="honest for 2 rounds to farm reputation, then ALIE",
    overrides=dict(attack="alie", malicious_frac=0.3, attack_z=1.0),
    knobs=dict(warmup=2, z=1.0),
    malicious_now=make_intermittent_hook(2),
    jit_hooks=JitHooks(malice_warmup=2),
))

IPM = register_scenario(Scenario(
    name="ipm", level="adaptive",
    description="inner-product manipulation: submit −ε·mean(honest)",
    overrides=dict(attack="ipm", malicious_frac=0.3, attack_scale=2.0),
    knobs=dict(epsilon=2.0),
))

MIN_MAX = register_scenario(Scenario(
    name="min_max", level="adaptive",
    description="largest perturbation inside the honest distance envelope",
    overrides=dict(attack="min_max", malicious_frac=0.3),
    knobs=dict(iters=20),
))

COLLUSION = register_scenario(Scenario(
    name="collusion", level="adaptive",
    description="colluders submit one agreed −mean(their updates)",
    overrides=dict(attack="collusion", malicious_frac=0.3,
                   attack_scale=1.0),
    knobs=dict(scale=1.0),
))

ADAPTIVE_SCENARIOS = (ALIE, ALIE_NORM, ALIE_SLEEPER, IPM, MIN_MAX,
                      COLLUSION)
