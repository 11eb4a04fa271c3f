"""Per-round event taps: stream each round's outputs out of a
multi-round ``Engine.run`` while it runs.

:func:`instrument` wraps a round step ``step(state, data, t) -> (state,
out)`` so that after every round it hands ``(t, RoundOut)`` — each field
copied to the host as a numpy array — to the module-level
:func:`_dispatch` trampoline; the actual consumer is installed at run
time with :func:`collecting`, so one tapped step serves every run (and
costs a no-op call a round when nothing is listening).

Nothing when disabled: ``instrument(step, None)`` and
``instrument(step, TapSpec(enabled=False))`` return ``step`` itself, so
an untapped run reads nothing from the device that the round does not
read already. An enabled tap copies the round's outputs to the host
after each round, which waits for that round's last kernel.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Optional

# the current consumer: (t, out) -> None. Installed by `collecting`;
# single-threaded use (matching the rest of the engine drivers).
_collector: Optional[Callable[[Any, Any], None]] = None


@dataclass(frozen=True)
class TapSpec:
    """Tap configuration."""
    enabled: bool = True


def _dispatch(t, out) -> None:
    """The tapped step's target: forwards to the installed collector,
    no-op otherwise. ``out`` keeps its ``RoundOut`` structure, with
    numpy fields."""
    if _collector is not None:
        _collector(t, out)


@contextmanager
def collecting(fn: Callable[[Any, Any], None]):
    """Install ``fn`` as the tap consumer for the duration of the
    ``with`` body (restores the previous consumer on exit). The tap
    dispatches synchronously after each round, so nothing is in flight
    on exit."""
    global _collector
    prev = _collector
    _collector = fn
    try:
        yield
    finally:
        _collector = prev


def instrument(step: Callable, tap: Optional[TapSpec]) -> Callable:
    """``step`` with a per-round event tap, or ``step`` itself when the
    tap is off or absent."""
    if tap is None or not tap.enabled:
        return step

    def tapped_step(state, data, t):
        new_state, out = step(state, data, t)
        host = [x.detach().cpu().numpy() for x in out]
        _dispatch(t, out._make(host) if hasattr(out, "_make")
                  else tuple(host))
        return new_state, out

    return tapped_step
