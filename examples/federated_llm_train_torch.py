"""End-to-end example on the PyTorch port: federated training of a small
decoder LM with Cost-TrustFL (the two-phase train step, Eq. 5-13) — the
port's counterpart of ``examples/federated_llm_train.py``.

4 client cohorts in 2 clouds, 3 selected a step, all on one device (one
rank holds every client). One cohort is malicious: it flips its tokens
(v -> vocab-1-v). The script prints the attacker's reputation against the
honest mean while the loss descends.

Run:  PYTHONPATH=src python examples/federated_llm_train_torch.py \\
          --steps 60 --device cpu          # or --device cuda (default)
"""
import argparse
import time
from dataclasses import replace
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_arch
from repro_torch.configs.base import FLConfig
from repro_torch.data import make_token_stream, token_batches
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.train import ClientMesh, make_fl_train_step
from repro_torch.tree import tree_leaves

N_COHORTS = 4


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--attack-cohort", type=int, default=3,
                    help="client cohort index that flips its tokens "
                         "(-1 disables)")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = replace(
        get_arch("gemma2-2b"), num_layers=args.layers, d_model=args.d_model,
        n_heads=4, n_kv_heads=2, head_dim=args.d_model // 4,
        d_ff=args.d_model * 3, vocab_size=2048, window=64, remat=False)
    model = Model(cfg)
    params = model.init(0, device=device)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"model: {n_params / 1e6:.1f}M params | {N_COHORTS} cohorts on "
          f"{device}")

    fl = FLConfig(n_clouds=2, clients_per_round=3)
    opt = adamw(cosine_schedule(3e-3, warmup=10, total=args.steps))
    step, topo = make_fl_train_step(model, ClientMesh(N_COHORTS), fl, opt,
                                    strategy="two_phase")
    print(f"topology: {topo.n_clients} client cohorts in {topo.n_clouds} "
          f"clouds (select {fl.clients_per_round}/round)")
    opt_state = opt[0](params)
    rep = torch.full((topo.n_clients,), 1.0 / topo.n_clients, device=device)

    # per-cohort disjoint token streams (non-IID: different seeds)
    streams = [make_token_stream(200_000, cfg.vocab_size, seed=i)
               for i in range(topo.n_clients)]
    iters = [token_batches(s, batch=2, seq=args.seq, seed=i)
             for i, s in enumerate(streams)]
    ref_iter = token_batches(make_token_stream(50_000, cfg.vocab_size,
                                               seed=99), 2, args.seq)

    def as_batch(toks: np.ndarray) -> dict:
        t = torch.as_tensor(toks, device=device).long()
        return {"tokens": t[..., :-1], "labels": t[..., 1:],
                "mask": torch.ones(t[..., 1:].shape, device=device)}

    def make_batch() -> dict:
        rows = []
        for i, it in enumerate(iters):
            tb = next(it)
            if i == args.attack_cohort:
                tb = cfg.vocab_size - 1 - tb    # label-corrupting flip
            rows.append(tb)
        return as_batch(np.concatenate(rows))            # (8, seq+1)

    def make_ref() -> dict:
        return as_batch(np.stack([next(ref_iter)
                                  for _ in range(topo.n_clouds)]))

    losses = []
    t0 = time.time()
    with step:
        for it in range(args.steps):
            params, opt_state, rep, met = step(params, opt_state, rep,
                                               make_batch(), make_ref())
            losses.append(float(met["loss"]))
            if (it + 1) % 10 == 0 or it == 0:
                r = rep.cpu().numpy()
                print(f"step {it + 1:4d} loss={losses[-1]:.4f} "
                      f"rep={np.array2string(r, precision=3)} "
                      f"cost_units={float(met['round_cost_units']):.3f} "
                      f"({(time.time() - t0) / (it + 1):.2f}s/step)")
    r = rep.cpu().numpy()
    out = {"rep": rep, "losses": losses, "params": params}
    if args.attack_cohort >= 0:
        honest = float(np.delete(r, args.attack_cohort).mean())
        out.update(attacker=float(r[args.attack_cohort]), honest=honest,
                   detected=bool(r[args.attack_cohort] < honest))
        print(f"\nreputation: attacker={r[args.attack_cohort]:.4f} "
              f"honest-mean={honest:.4f} "
              f"({'DETECTED' if out['detected'] else 'missed'})")
    if args.ckpt:
        save_checkpoint(args.ckpt, {"params": params, "rep": rep},
                        step=args.steps, metadata={"arch": cfg.name})
        print(f"checkpoint -> {args.ckpt}")
    return out


if __name__ == "__main__":
    main()
