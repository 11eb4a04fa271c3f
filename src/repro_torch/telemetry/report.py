"""Telemetry report: validate a JSONL event stream and render summary
tables from events alone (the reference's report, on the port's
schema module; either package's streams validate in either)::

    PYTHONPATH=src python -m repro_torch.telemetry.report events.jsonl
    PYTHONPATH=src python -m repro_torch.telemetry.report events.jsonl --validate-only

``--validate-only`` exits 1 on any schema violation.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Sequence, Union

from repro_torch.telemetry.schema import validate_events

MB = 1024.0 ** 2


def load_events(path: Union[str, Path]) -> List[Dict[str, Any]]:
    """Decode a JSONL event file (raises on malformed JSON, with the
    offending line number)."""
    events = []
    with Path(path).open() as fh:
        for i, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i}: not valid JSON: {e}") from e
    return events


def wire_breakdown(events: Iterable[Dict[str, Any]],
                   label_key: str = "run_id") -> List[Dict[str, Any]]:
    """Per-run wire/cost rows from ``round`` events alone: mean
    intra/cross bytes and $ per round, mean compression ratio. Rows
    appear in first-emission order of their label."""
    rows: Dict[str, Dict[str, Any]] = {}
    for ev in events:
        if ev.get("event") != "round":
            continue
        label = str(ev.get(label_key))
        r = rows.setdefault(label, {
            "label": label, "engine": ev.get("engine"),
            "method": ev.get("method"), "rounds": 0,
            "intra_bytes": 0.0, "cross_bytes": 0.0, "cost": 0.0,
            "compression_ratio": 0.0})
        r["rounds"] += 1
        r["intra_bytes"] += ev["intra_bytes"]
        r["cross_bytes"] += ev["cross_bytes"]
        r["cost"] += ev["cost"]
        r["compression_ratio"] += ev["compression_ratio"]
    out = []
    for r in rows.values():
        n = r["rounds"]
        out.append({**r,
                    "intra_bytes": r["intra_bytes"] / n,
                    "cross_bytes": r["cross_bytes"] / n,
                    "cost": r["cost"] / n,
                    "compression_ratio": r["compression_ratio"] / n})
    return out


def render_wire_table(rows: Sequence[Dict[str, Any]],
                      label_header: str = "run") -> str:
    """The wire-breakdown table (per-round means; ``cross vs first``
    compares each row's cross bytes against the first row's — the
    uncompressed baseline when the caller orders it first)."""
    lines = [f"{label_header:26s}{'intra MB':>10s}{'cross MB':>10s}"
             f"{'$/round':>10s}{'cross vs first':>15s}",
             "-" * 71]
    base_cross = None
    for r in rows:
        base_cross = base_cross if base_cross is not None \
            else r["cross_bytes"]
        ratio = base_cross / max(r["cross_bytes"], 1.0)
        lines.append(f"{r['label'][:26]:26s}{r['intra_bytes'] / MB:10.2f}"
                     f"{r['cross_bytes'] / MB:10.2f}{r['cost']:10.6f}"
                     f"{ratio:14.2f}x")
    return "\n".join(lines)


def summarize(events: Sequence[Dict[str, Any]]) -> str:
    """One-paragraph stream summary (counts per event type, runs seen,
    final cumulative $ per run)."""
    counts: Dict[str, int] = {}
    finals: Dict[str, float] = {}
    for ev in events:
        counts[ev.get("event", "?")] = counts.get(ev.get("event", "?"), 0) + 1
        if ev.get("event") == "round":
            finals[str(ev.get("run_id"))] = ev.get("cum_cost", 0.0)
    parts = [f"{len(events)} events "
             f"({', '.join(f'{k}={v}' for k, v in sorted(counts.items()))})"]
    for run, cost in finals.items():
        parts.append(f"  {run}: cum_cost=${cost:.6f}")
    return "\n".join(parts)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path", help="telemetry JSONL file")
    ap.add_argument("--validate-only", action="store_true",
                    help="schema-check only; exit 1 on any violation")
    args = ap.parse_args(argv)

    events = load_events(args.path)
    errors = validate_events(events)
    if errors:
        print(f"SCHEMA INVALID ({len(errors)} violations):",
              file=sys.stderr)
        for e in errors[:50]:
            print(f"  {e}", file=sys.stderr)
        return 1
    if args.validate_only:
        print(f"{args.path}: {len(events)} events, schema OK")
        return 0

    print(summarize(events))
    rows = wire_breakdown(events)
    if rows:
        print()
        print(render_wire_table(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
