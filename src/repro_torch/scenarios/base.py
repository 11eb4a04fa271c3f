"""Scenario core: a ``Scenario`` bundles FLConfig overrides, an attack
(by registry name, through the ``attack`` override) and the round
environment into one named, registrable unit that ``FLServer``,
``run_simulation`` and ``compare_methods`` share.

The environment enters the round engine as data, a :class:`JitHooks`:
a dropout probability, an active-malice warmup round and a per-round
``c_cross`` multiplier schedule. A scenario may also carry host hooks
(``on_round_start``, ``deliver``, ``malicious_now``), called by the
reference's host round loop; the port has no host loop yet, so a
scenario whose host hooks have no ``jit_hooks`` equivalent is refused
(``jittable`` is False) until ROADMAP queue A item 3.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, Optional, Tuple

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
    engine reads. The host-hook fields are callables of the reference's
    host loop (``repro/scenarios/base.py``)."""
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
