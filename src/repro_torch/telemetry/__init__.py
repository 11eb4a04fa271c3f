"""Telemetry: typed per-round event streams, profiler spans and state
digests for both round loops (the round engine and the host loop) and
the multi-seed batch driver, in the reference's schema
(``cost-trustfl/telemetry/v1.1``).

Quick start::

    from repro_torch.telemetry import Telemetry
    from repro_torch.federated import run_simulation

    with Telemetry.to_jsonl("events.jsonl") as tel:
        run_simulation(flcfg, rounds=20, telemetry=tel)

then ``python -m repro_torch.telemetry.report events.jsonl``.

Layout: ``schema`` (event types + the ``RunContext`` factory +
validation), ``sinks`` (JSONL / ring buffer / recorder), ``taps``
(per-round streaming out of ``Engine.run``; nothing when disabled),
``spans`` (``record_function`` timing + ``torch.profiler`` capture),
``provenance`` (git/host/card stamps), ``report`` (validation CLI +
wire-breakdown tables from events alone).
"""
from repro_torch.telemetry.provenance import stamp
from repro_torch.telemetry.schema import (ENGINES, EVENT_TYPES, SCHEMA,
                                          RunContext, delivered_sha, encode,
                                          validate_event, validate_events)
from repro_torch.telemetry.sinks import (JsonlSink, ListSink, RingBufferSink,
                                         Telemetry)
from repro_torch.telemetry.spans import span, start_trace, stop_trace, trace
from repro_torch.telemetry.taps import TapSpec, collecting, instrument

__all__ = [
    "SCHEMA", "EVENT_TYPES", "ENGINES", "RunContext", "delivered_sha",
    "encode", "validate_event", "validate_events",
    "Telemetry", "JsonlSink", "RingBufferSink", "ListSink",
    "TapSpec", "collecting", "instrument",
    "span", "trace", "start_trace", "stop_trace", "stamp",
]
