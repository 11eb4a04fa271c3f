"""Egress-cost report on the PyTorch port — the port's counterpart of
``examples/cost_report.py``: prices the cross-pod collective traffic of
the multi-pod dry-run records (``results/dryrun/*pod2*.json``, plain
JSON) at the paper's cloud rates (Eq. 1-2, $0.09/GB egress), then the
FL round wire breakdown under each compression policy, rendered from
telemetry events alone. Touches no device. With no dry-run records it
prints the empty table.

Run:  PYTHONPATH=src python examples/cost_report_torch.py [--dir results/dryrun]
      PYTHONPATH=src python examples/cost_report_torch.py --events events.jsonl
"""
import argparse
import glob
import json
import os
from typing import Optional, Sequence

import numpy as np

from repro_torch.compress import build_link_policy
from repro_torch.core import CloudTopology, CostModel
from repro_torch.telemetry import ListSink, Telemetry
from repro_torch.telemetry import report
from repro_torch.telemetry.schema import RunContext

GB = 1024 ** 3
MB = 1024 ** 2

POLICIES = [
    ("fp32 / none", "none", {}),
    ("topk 0.1 / cross_only", "topk", {"ratio": 0.1}),
    ("topk 0.1 / all", "topk", {"ratio": 0.1, "link_policy": "all"}),
    ("qsgd 5-bit / cross_only", "qsgd", {"levels": 15}),
]


def fl_policy_events(n_clouds: int = 3, clients_per_cloud: int = 30,
                     d_params: int = 600_000) -> list:
    """One synthetic ``round`` telemetry event per compression policy
    (full participation, hierarchical) — the FL wire breakdown expressed
    as the same event stream every round loop emits, so the table below
    is rendered by the shared ``repro_torch.telemetry.report`` path."""
    topo = CloudTopology.even(n_clouds, clients_per_cloud)
    sel = np.ones(topo.n_clients, bool)
    sink = ListSink()
    with Telemetry(sink) as tel:
        for name, kind, kw in POLICIES:
            lp = build_link_policy(kind, **kw)
            client, edge = lp.payload_vectors(topo, d_params)
            ctx = RunContext(
                tel, engine="host", run_id=name, method="cost_trustfl",
                attack="none", seed=0, topo=topo, d_params=d_params,
                hierarchical=True, m_selected=topo.n_clients,
                malicious=np.zeros(topo.n_clients, bool),
                client_payload=client, edge_payload=edge)
            ctx.round(0, sel, np.ones(topo.n_clients), 0.0)
    return sink.events


def fl_breakdown(n_clouds: int = 3, clients_per_cloud: int = 30,
                 d_params: int = 600_000) -> str:
    """Per-round intra/cross wire bytes + $ for the simulation topology
    under each compression policy, built from telemetry events alone."""
    events = fl_policy_events(n_clouds, clients_per_cloud, d_params)
    rows = report.wire_breakdown(events)
    return (f"\nFL round wire breakdown ({n_clouds}x{clients_per_cloud} "
            f"clients, d={d_params:,}, full participation, hierarchical):\n"
            + report.render_wire_table(rows, label_header="policy"))


def main(argv: Optional[Sequence[str]] = None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--steps-per-round", type=int, default=1,
                    help="train steps per FL round (local epochs)")
    ap.add_argument("--events", default=None, metavar="JSONL",
                    help="render the wire breakdown from a recorded "
                         "telemetry JSONL instead of the dry-run sweep")
    args = ap.parse_args(argv)
    if args.events:
        rows = report.wire_breakdown(report.load_events(args.events))
        print(report.render_wire_table(rows))
        return rows
    cm = CostModel()

    rows = []
    for p in sorted(glob.glob(os.path.join(args.dir, "*pod2*.json"))):
        with open(p) as fh:
            r = json.load(fh)
        if r.get("status") != "ok":
            continue
        cross = r.get("cross_pod_bytes_per_device", 0) * r.get("chips", 0) / 2
        intra = (r.get("collective_bytes_per_device", 0) * r.get("chips", 0)
                 - cross)
        dollars = cm.collective_egress_dollars(int(cross))
        rows.append((r["arch"], r["shape"], cross / GB, intra / GB, dollars))

    print(f"{'arch':28s}{'shape':14s}{'cross-pod GB':>14s}"
          f"{'intra GB':>12s}{'egress $/step':>15s}")
    print("-" * 83)
    total = 0.0
    for arch, shape, cgb, igb, d in rows:
        total += d
        print(f"{arch:28s}{shape:14s}{cgb:14.2f}{igb:12.1f}{d:15.4f}")
    print("-" * 83)
    print(f"{'(1 round = %d step(s))' % args.steps_per_round:56s}"
          f"{'total':>12s}{total * args.steps_per_round:15.4f}")
    print("\nInterpretation: the hierarchical two_phase step keeps the "
          "full-gradient all-reduce INSIDE each pod; only the K cloud "
          "aggregates cross the pod boundary (Eq. 5-6) — compare "
          "cross-pod vs intra columns.")

    print(fl_breakdown())
    return rows


if __name__ == "__main__":
    main()
