"""Scenario core: a ``Scenario`` bundles FLConfig overrides, an attack
(by registry name, through the ``attack`` override) and the round
environment into one named, registrable unit that ``FLServer``,
``run_simulation`` and ``compare_methods`` share.

Host hooks (all optional, duck-typed against ``FLServer``), which the
host round loop calls through the dispatch methods below:

* ``on_round_start(server, t, rng)`` — environment mutation before
  selection, e.g. dynamic egress pricing swaps ``server.cost_model`` and
  ``server.unit_costs``;
* ``deliver(server, t, rng, sel) -> sel`` — post-selection delivery
  mask, e.g. dropout (dropped clients neither train nor pay bytes);
* ``malicious_now(server, t) -> (N,) bool`` — per-round active-malice
  mask, e.g. sleepers honest for a warmup window.

Hooks must be deterministic given ``(server.seed, t, rng)``. The round
engine cannot call them, so a scenario that wants it declares its
environment as data, a :class:`JitHooks`: a dropout probability, an
active-malice warmup round and a per-round ``c_cross`` multiplier
schedule. A scenario with host hooks and no ``jit_hooks`` runs in the
host loop only (``jittable`` is False).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np

from repro_torch.configs.base import FLConfig

LEVELS = ("static", "adaptive", "environment")


@dataclass(frozen=True)
class JitHooks:
    """The environment as data; every field composes (a scenario may drop
    AND surge prices) and the defaults are no-ops.

    * ``p_drop`` — each selected client independently fails to deliver
      with this probability (at least one always delivers).
    * ``malice_warmup`` — the static malicious set is inactive for the
      first ``malice_warmup`` rounds (sleeper adversaries farming EMA).
    * ``price_multipliers`` — per-round ``c_cross`` multiplier schedule,
      cycled as ``multipliers[t % len]``; seen by Eq. 10 selection and
      the round's $ alike.
    """
    p_drop: float = 0.0
    malice_warmup: int = 0
    price_multipliers: Tuple[float, ...] = (1.0,)


@dataclass(frozen=True)
class Scenario:
    """A named adversary/environment configuration.

    ``overrides`` are applied to the caller's ``FLConfig``; ``knobs``
    documents the scenario's parameters; ``jit_hooks`` is what the round
    engine reads; the host-hook fields are what the host round loop
    calls."""
    name: str
    level: str                                   # one of LEVELS
    description: str = ""
    overrides: Dict[str, Any] = field(default_factory=dict)
    knobs: Dict[str, Any] = field(default_factory=dict)
    on_round_start: Optional[Callable] = None
    deliver: Optional[Callable] = None
    malicious_now: Optional[Callable] = None
    jit_hooks: Optional[JitHooks] = None

    def __post_init__(self):
        if self.level not in LEVELS:
            raise ValueError(f"level {self.level!r} not in {LEVELS}")

    @property
    def jittable(self) -> bool:
        """True when the round engine can run this scenario: it declares
        ``jit_hooks``, or it has no per-round host behaviour at all."""
        if self.jit_hooks is not None:
            return True
        return (self.on_round_start is None and self.deliver is None
                and self.malicious_now is None)

    def apply(self, flcfg: FLConfig) -> FLConfig:
        """FLConfig with this scenario's overrides applied (idempotent)."""
        return replace(flcfg, **self.overrides) if self.overrides else flcfg

    # -- hook dispatch (no-ops when the hook is unset) ------------------------
    def round_start(self, server, t: int, rng: np.random.Generator) -> None:
        if self.on_round_start is not None:
            self.on_round_start(server, t, rng)

    def delivered(self, server, t: int, rng: np.random.Generator,
                  sel: np.ndarray) -> np.ndarray:
        return sel if self.deliver is None else self.deliver(server, t, rng,
                                                             sel)

    def active_malicious(self, server, t: int) -> np.ndarray:
        if self.malicious_now is None:
            return server.malicious
        return self.malicious_now(server, t)


_SCENARIOS: Dict[str, Scenario] = {}


def register_scenario(scenario: Scenario) -> Scenario:
    if scenario.name in _SCENARIOS:
        raise ValueError(f"scenario {scenario.name!r} already registered")
    _SCENARIOS[scenario.name] = scenario
    return scenario


def get_scenario(name: str) -> Scenario:
    if name not in _SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; known: {list_scenarios()}")
    return _SCENARIOS[name]


def list_scenarios(level: Optional[str] = None) -> Tuple[str, ...]:
    return tuple(sorted(n for n, s in _SCENARIOS.items()
                        if level is None or s.level == level))
