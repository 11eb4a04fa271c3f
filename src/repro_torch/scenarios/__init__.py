"""Composable adversary + environment scenarios (the port of
``repro/scenarios``).

Importing this package registers every built-in scenario; enumerate them
with ``list_scenarios()`` and pass one to ``run_simulation(...,
scenario=name_or_obj)``, ``FLServer(scenario=...)`` or
``compare_methods(..., scenario=...)``. The round engine reads a
scenario's ``jit_hooks`` (dropout, malice warmup, price schedule); the
host round loop calls its host hooks (``make_dropout_hook``,
``make_intermittent_hook``, ``make_price_surge_hook``).
"""
from repro_torch.scenarios.base import (LEVELS, JitHooks, Scenario,
                                        get_scenario, list_scenarios,
                                        register_scenario)
from repro_torch.scenarios.static import STATIC_SCENARIOS
from repro_torch.scenarios.adaptive import ADAPTIVE_SCENARIOS
from repro_torch.scenarios.environment import (ENVIRONMENT_SCENARIOS,
                                               make_dropout_hook,
                                               make_intermittent_hook,
                                               make_price_surge_hook)

__all__ = ["LEVELS", "JitHooks", "Scenario", "get_scenario",
           "list_scenarios", "register_scenario", "STATIC_SCENARIOS",
           "ADAPTIVE_SCENARIOS", "ENVIRONMENT_SCENARIOS",
           "make_dropout_hook", "make_intermittent_hook",
           "make_price_surge_hook"]
