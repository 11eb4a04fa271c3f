"""The paper's four static attacks (Table I, 30% malicious) as registered
scenarios. ``sign_flip`` pins ``attack_scale=1.0`` (the paper's g ← −g);
``scaling`` keeps the model-replacement ×10."""
from __future__ import annotations

from repro_torch.scenarios.base import Scenario, register_scenario

LABEL_FLIP = register_scenario(Scenario(
    name="label_flip", level="static",
    description="30% of clients train on randomly permuted labels",
    overrides=dict(attack="label_flip", malicious_frac=0.3),
))

GAUSSIAN = register_scenario(Scenario(
    name="gaussian", level="static",
    description="malicious updates carry additive N(0, σ²) noise",
    overrides=dict(attack="gaussian", malicious_frac=0.3,
                   gaussian_sigma=1.0),
    knobs=dict(sigma=1.0),
))

SIGN_FLIP = register_scenario(Scenario(
    name="sign_flip", level="static",
    description="malicious updates negated (g ← −g)",
    overrides=dict(attack="sign_flip", malicious_frac=0.3,
                   attack_scale=1.0),
    knobs=dict(scale=1.0),
))

SCALING = register_scenario(Scenario(
    name="scaling", level="static",
    description="malicious updates amplified ×10 (model replacement)",
    overrides=dict(attack="scaling", malicious_frac=0.3,
                   attack_scale=10.0),
    knobs=dict(scale=10.0),
))

STATIC_SCENARIOS = (LABEL_FLIP, GAUSSIAN, SIGN_FLIP, SCALING)
