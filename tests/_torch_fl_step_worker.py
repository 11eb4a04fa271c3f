"""The port-only side of ``tests/test_torch_fl_steps.py``: the small
configurations, their seeded inputs, the port's federated train steps
chained on the CPU, and the code of the spawned gloo ranks of its
multi-rank test. Imports neither ``jax`` nor anything of ``repro``. Not a
test module (leading underscore).

As a rank of a gloo group (``STORE`` a file the ranks rendezvous on;
rank r writes ``OUT_r.npz``)::

    python tests/_torch_fl_step_worker.py RANK WORLD STORE OUT [moe]

Every rank runs ``SPAWNED`` over the whole group, each case's Ω drawn
from its seed on the CPU (fields ``<case>/<field>``); with ``moe``, one
MoE layer (``moe_inputs``) on the rank's block of rows under
``route_over_ranks`` instead (:func:`moe_fields`).
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
# name -> (arch, d_model, layers, num_layers (None: ``layers``), strategy,
# config fields replaced after ``reduced``); a case's seed is its place
# here. mixtral: capacity factor 0.5, so its layers drop tokens at world
# size 1 and route differently per rank than over the global batch;
# whisper: ``reduced`` turns RoPE on, 0 puts the sinusoids back
CASES = {
    "gemma2_fused": ("gemma2-2b", 64, 2, None, "fused", {}),
    "gemma2_two_phase": ("gemma2-2b", 64, 2, None, "two_phase", {}),
    "rg_two_phase": ("recurrentgemma-2b", 64, 3, None, "two_phase", {}),
    "mixtral_fused": ("mixtral-8x7b", 64, 2, None, "fused",
                      {"capacity_factor": 0.5}),
    "rwkv6_two_phase": ("rwkv6-1.6b", 64, 2, None, "two_phase", {}),
    "whisper_two_phase": ("whisper-small", 64, 2, None, "two_phase",
                          {"rope_theta": 0.0}),
    "paligemma_two_phase": ("paligemma-3b", 64, 2, None, "two_phase", {}),
    "paligemma_fused": ("paligemma-3b", 64, 2, None, "fused", {}),
}
SPAWNED = ("gemma2_two_phase", "gemma2_fused", "mixtral_fused")
# the routing mode's own case: one mixtral MoE layer (d_model 64, 4
# experts, top-2, capacity factor 0.5) over MOE_ROWS rows of SEQ tokens
MOE_ROWS = 4
METRICS = ("loss", "phi", "trust", "beta", "selected", "round_cost_units")


def port_cfg(name: str):
    from repro_torch.configs import get_arch, reduced

    arch, d_model, layers, num_layers, _, over = CASES[name]
    cfg = reduced(get_arch(arch), d_model=d_model, layers=layers)
    if num_layers is not None:
        cfg = replace(cfg, num_layers=num_layers)
    return replace(cfg, **over)


def inputs(name: str):
    """(the port's seeded weights, [(batch, ref_batch)] a step as numpy):
    client-major rows of random tokens, labels the next tokens, the last
    position masked out and one client's rows half masked; a VLM's rows
    also hold 0.02·N(0, 1) ``patches`` before their SEQ text tokens, an
    encoder-decoder's ``frames``."""
    from repro_torch.models.model import Model

    cfg = port_cfg(name)
    seed = list(CASES).index(name)
    params = Model(cfg).init(seed, device="cpu")
    rng = np.random.default_rng(seed)
    steps = []
    for _ in range(STEPS):
        def rows(*lead):
            toks = rng.integers(0, cfg.vocab_size, lead + (SEQ + 1,),
                                dtype=np.int32)
            mask = np.ones(lead + (SEQ,), np.float32)
            mask[..., -1] = 0.0
            out = {"tokens": toks[..., :-1], "labels": toks[..., 1:],
                   "mask": mask}
            for key, n in (("patches", cfg.vis_tokens),
                           ("frames", cfg.enc_frames * cfg.is_encdec)):
                if n:
                    out[key] = 0.02 * rng.standard_normal(
                        lead + (n, cfg.d_model)).astype(np.float32)
            return out
        batch = rows(N_CLIENTS * PER)
        batch["mask"][PER:2 * PER, SEQ // 2:] = 0.0      # client 1
        steps.append((batch, rows(N_CLOUDS, REF_ROWS)))
    return params, steps


def tensors(batch: dict) -> dict:
    """Integer leaves as int64, the rest (mask, patches, frames) fp32."""
    return {k: torch.tensor(v).long() if v.dtype.kind == "i"
            else torch.tensor(v) for k, v in batch.items()}


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


def moe_inputs():
    """(config, the MoE layer's weights, x of MOE_ROWS x SEQ tokens) as
    numpy, from a seed: the routing mode's case."""
    from repro_torch.configs import get_arch, reduced

    cfg = replace(reduced(get_arch("mixtral-8x7b"), d_model=64),
                  capacity_factor=0.5)
    rng = np.random.default_rng(11)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    params = {"router": rng.standard_normal((d, e)),
              "w_up": rng.standard_normal((e, d, f)) / np.sqrt(d),
              "w_gate": rng.standard_normal((e, d, f)) / np.sqrt(d),
              "w_down": rng.standard_normal((e, f, d)) / np.sqrt(f)}
    x = rng.standard_normal((MOE_ROWS, SEQ, d))
    return (cfg, {k: v.astype(np.float32) for k, v in params.items()},
            x.astype(np.float32))


def moe_fields(rank: int, world: int) -> dict:
    """One MoE layer on this rank's block of ``moe_inputs``' rows under
    ``route_over_ranks``: its output rows, its aux share and the share's
    gradient in the router, and the kept (expert, global token) pairs."""
    from repro_torch.models import moe

    cfg, params, x = moe_inputs()
    per = MOE_ROWS // world
    p = {k: torch.tensor(v) for k, v in params.items()}
    p["router"].requires_grad_()
    x_loc = torch.tensor(x[rank * per:(rank + 1) * per])
    kept = []
    real = moe.route

    def spy(combine, cap):
        rt = real(combine, cap)
        kept.append(np.stack([rt.expert.numpy(), rt.token.numpy()], 1))
        return rt
    moe.route = spy
    try:
        with moe.route_over_ranks():
            out, aux = moe.moe_forward(p, x_loc, cfg)
    finally:
        moe.route = real
    (g_router,) = torch.autograd.grad(aux, [p["router"]])
    return {"out": out.detach().numpy(), "aux": aux.detach().numpy(),
            "aux_grad_router": g_router.numpy(), "kept": kept[0]}


def main(argv) -> int:
    rank, world, store, out = int(argv[1]), int(argv[2]), argv[3], argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        fields = {}
        if argv[5:] == ["moe"]:
            fields = moe_fields(rank, world)
        else:
            for name in SPAWNED:
                recs, params = run_steps(name)
                for t, rec in enumerate(recs):
                    fields.update({f"{name}/{t}/{k}": v
                                   for k, v in rec.items()})
                fields[f"{name}/params"] = flat(params)
    finally:
        dist.destroy_process_group()
    np.savez(f"{out}_{rank}.npz", **fields)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    sys.exit(main(sys.argv))
