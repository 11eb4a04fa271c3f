"""Byzantine-defense grid on the PyTorch port (Table I at reduced scale):
every registered ``repro_torch.scenarios`` scenario x defense method on
the synthetic CIFAR-10 surrogate — the port's counterpart of
``examples/byzantine_defense.py``. Static rows reproduce the paper's
Table I; adaptive and environment rows are out-of-paper extensions.

Run:  PYTHONPATH=src python examples/byzantine_defense_torch.py \\
          [--rounds 8] [--static] [--device cpu]
      (--static: the paper's four attacks only; --device cuda is the
      default)
"""
import argparse
from typing import Optional, Sequence

from repro_torch.configs.base import FLConfig
from repro_torch.device import resolve_device
from repro_torch.federated import compare_methods
from repro_torch.scenarios import get_scenario, list_scenarios

METHODS = ["fedavg", "krum", "trimmed_mean", "fltrust", "cost_trustfl"]


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--static", action="store_true",
                    help="only the paper's four static attacks")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # static columns in the paper's Table I order, extensions after
    static = ["label_flip", "gaussian", "sign_flip", "scaling"]
    names = (static if args.static
             else static + [n for lvl in ("adaptive", "environment")
                            for n in list_scenarios(lvl)])

    table, levels = {}, {}
    for name in names:
        sc = get_scenario(name)
        levels[name] = sc.level
        fl = FLConfig(n_clouds=3, clients_per_cloud=6, clients_per_round=9,
                      local_epochs=1, local_batch=16, ref_samples=32)
        runs = compare_methods(fl, METHODS, scenario=sc, rounds=args.rounds,
                               device=device)
        for m, r in runs.items():
            table[(m, name)] = r.final_accuracy

    header = f"{'method':14s}" + "".join(f"{n:>13s}" for n in names)
    print("\nTest accuracy (reduced-scale Table I + scenario extensions)")
    print(header)
    print(f"{'level':14s}" + "".join(f"{levels[n][:11]:>13s}" for n in names))
    print("-" * len(header))
    for m in METHODS:
        print(f"{m:14s}" + "".join(f"{table[(m, n)]:13.4f}" for n in names))
    print("\npaper (200 rounds, real CIFAR-10),")
    print("none/label_flip/gaussian/sign_flip/scaling:")
    print("FedAvg 89.1/68.3/54.5/41.2/32.8 | Ours 91.2/86.7/87.8/85.5/84.1")
    return {"table": table, "levels": levels, "scenarios": names}


if __name__ == "__main__":
    main()
