"""Quickstart on the PyTorch port: Cost-TrustFL vs FedAvg under a
label-flipping attack — the port's counterpart of
``examples/quickstart.py``.

3 simulated clouds x 6 clients, 30% malicious, synthetic CIFAR-10
surrogate. Prints per-round accuracy and the cumulative egress cost —
the paper's two headline metrics (Table I + Fig. 3).

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--rounds 10] \\
          [--device cpu]                   # --device cuda is the default

``--telemetry events.jsonl`` records both runs as a telemetry event
stream; inspect with ``python -m repro_torch.telemetry.report
events.jsonl``.
"""
import argparse
import contextlib
from typing import Optional, Sequence

from repro_torch.configs.base import FLConfig
from repro_torch.device import resolve_device
from repro_torch.federated import run_simulation
from repro_torch.telemetry import Telemetry


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--attack", default="label_flip",
                    choices=["none", "label_flip", "gaussian", "sign_flip",
                             "scaling"])
    ap.add_argument("--malicious", type=float, default=0.3)
    ap.add_argument("--trust-features", default="scalar",
                    choices=["scalar", "multi"],
                    help="Eq. 7 scalar score, or the adaptively-weighted "
                         "multi-feature gate (repro_torch.core.features)")
    ap.add_argument("--telemetry", default=None, metavar="JSONL",
                    help="record round/eval/span events to this file")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    fl = FLConfig(attack=args.attack, malicious_frac=args.malicious,
                  trust_features=args.trust_features,
                  n_clouds=3, clients_per_cloud=6, clients_per_round=9,
                  local_epochs=2, local_batch=16, ref_samples=32)

    tel = (Telemetry.to_jsonl(args.telemetry) if args.telemetry
           else None)
    print(f"== Cost-TrustFL vs FedAvg | attack={args.attack} "
          f"({args.malicious:.0%} malicious) on {device} ==")
    with (tel if tel is not None else contextlib.nullcontext()):
        ours = run_simulation(fl, method="cost_trustfl",
                              rounds=args.rounds, eval_every=2,
                              device=device, telemetry=tel, verbose=True)
        base = run_simulation(fl, method="fedavg", rounds=args.rounds,
                              eval_every=2, device=device, telemetry=tel,
                              verbose=True)
    if args.telemetry:
        print(f"telemetry: {args.telemetry}")

    print("\n--- summary -------------------------------------------")
    print(f"Cost-TrustFL : acc={ours.final_accuracy:.4f}  "
          f"cost=${ours.total_cost:.4f}")
    print(f"FedAvg       : acc={base.final_accuracy:.4f}  "
          f"cost=${base.total_cost:.4f}")
    if base.total_cost:
        print(f"cost reduction: "
              f"{1 - ours.total_cost / base.total_cost:.1%} "
              f"(paper reports 32%)")
    mal = ours.malicious
    honest_rep = float(ours.reputation[~mal].mean())
    malicious_rep = float(ours.reputation[mal].mean())
    print(f"mean reputation honest={honest_rep:.4f} "
          f"malicious={malicious_rep:.4f}")
    return {"ours": ours, "base": base, "honest_rep": honest_rep,
            "malicious_rep": malicious_rep}


if __name__ == "__main__":
    main()
