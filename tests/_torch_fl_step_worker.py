"""The port-only side of ``tests/test_torch_fl_steps.py``: the small
configurations, their seeded inputs, the port's federated train steps
chained on the CPU, and the code of the spawned gloo ranks of its
multi-rank test. Imports neither ``jax`` nor anything of ``repro``. Not a
test module (leading underscore).

As a rank of a gloo group (``STORE`` a file the ranks rendezvous on;
rank r writes ``OUT_r.npz``)::

    python tests/_torch_fl_step_worker.py RANK WORLD STORE OUT

Every rank runs ``SPAWNED`` over the whole group, each case's Ω drawn
from its seed on the CPU (fields ``<case>/<field>``).
"""
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

CPU = torch.device("cpu")

N_CLIENTS, N_CLOUDS = 4, 2
FL = dict(n_clouds=N_CLOUDS, clients_per_round=3)
PER, REF_ROWS, SEQ = 2, 2, 16     # rows a client, rows a cloud's reference
LR, STEPS = 0.05, 2
# 16 positions in chunks of 6: two whole chunks and a remainder of 4 —
# the loss's last, shorter chunk, and the 4 positions the fused
# signatures leave out
LOSS_CHUNK = 6
# name -> (arch, d_model, layers, num_layers (None: ``layers``), strategy)
CASES = {
    "gemma2_two_phase": ("gemma2-2b", 64, 2, None, "two_phase"),
    "gemma2_fused": ("gemma2-2b", 64, 2, None, "fused"),
    "rg_two_phase": ("recurrentgemma-2b", 64, 3, None, "two_phase"),
}
SPAWNED = ("gemma2_two_phase", "gemma2_fused")
METRICS = ("loss", "phi", "trust", "beta", "selected", "round_cost_units")


def port_cfg(name: str):
    from repro_torch.configs import get_arch, reduced

    arch, d_model, layers, num_layers, _ = CASES[name]
    cfg = reduced(get_arch(arch), d_model=d_model, layers=layers)
    return cfg if num_layers is None else replace(cfg, num_layers=num_layers)


def inputs(name: str):
    """(the port's seeded weights, [(batch, ref_batch)] a step as numpy):
    client-major rows of random tokens, labels the next tokens, the last
    position masked out and one client's rows half masked."""
    from repro_torch.models.model import Model

    cfg = port_cfg(name)
    seed = sorted(CASES).index(name)
    params = Model(cfg).init(seed, device="cpu")
    rng = np.random.default_rng(seed)
    steps = []
    for _ in range(STEPS):
        def rows(*lead):
            toks = rng.integers(0, cfg.vocab_size, lead + (SEQ + 1,),
                                dtype=np.int32)
            mask = np.ones(lead + (SEQ,), np.float32)
            mask[..., -1] = 0.0
            return {"tokens": toks[..., :-1], "labels": toks[..., 1:],
                    "mask": mask}
        batch = rows(N_CLIENTS * PER)
        batch["mask"][PER:2 * PER, SEQ // 2:] = 0.0      # client 1
        steps.append((batch, rows(N_CLOUDS, REF_ROWS)))
    return params, steps


def tensors(batch: dict) -> dict:
    return {k: torch.tensor(v) if k == "mask" else torch.tensor(v).long()
            for k, v in batch.items()}


def run_steps(name: str, omegas=None, group=None):
    """``STEPS`` chained steps of the case's strategy with SGD on the
    port, every client on the ranks of ``group`` (default: the default
    group; a one-rank one is started and ended when none is
    initialized). ``omegas``: the fused step's Ω a step (default: seeds
    1, 2, ... drawn on the CPU). Returns (a record per step {metric: array,
    "rep": array}, the final params)."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.models.model import Model
    from repro_torch.optim import sgd
    from repro_torch.train import ClientMesh, make_fl_train_step

    params, steps = inputs(name)
    strategy = CASES[name][4]
    opt = sgd(LR)
    opt_state = opt[0](params)
    step, topo = make_fl_train_step(
        Model(port_cfg(name)), ClientMesh(N_CLIENTS, group=group),
        FLConfig(**FL), opt, strategy=strategy, loss_chunk=LOSS_CHUNK)
    rep = torch.full((topo.n_clients,), 1.0 / topo.n_clients)
    recs = []
    with step:
        for t, (batch, ref) in enumerate(steps):
            key = (() if strategy == "two_phase" else
                   (t + 1 if omegas is None else torch.tensor(omegas[t]),))
            params, opt_state, rep, met = step(params, opt_state, rep,
                                               tensors(batch), tensors(ref),
                                               *key)
            rec = {k: met[k].numpy().copy() for k in METRICS}
            rec["rep"] = rep.numpy().copy()
            recs.append(rec)
    return recs, params


def flat(params) -> np.ndarray:
    from repro_torch.tree import tree_leaves

    return np.concatenate([x.detach().numpy().ravel()
                           for x in tree_leaves(params)])


def main(argv) -> int:
    rank, world, store, out = int(argv[1]), int(argv[2]), argv[3], argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        fields = {}
        for name in SPAWNED:
            recs, params = run_steps(name)
            for t, rec in enumerate(recs):
                fields.update({f"{name}/{t}/{k}": v for k, v in rec.items()})
            fields[f"{name}/params"] = flat(params)
    finally:
        dist.destroy_process_group()
    np.savez(f"{out}_{rank}.npz", **fields)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    sys.exit(main(sys.argv))
