"""The spawned gloo ranks of ``tests/test_torch_mesh_steps.py``: the
federated train steps over a ``DeviceMesh`` against the same steps over
a ``ClientMesh`` on the ranks of one model index. Imports neither
``jax`` nor anything of ``repro``. Not a test module (leading
underscore).

As rank RANK of WORLD gloo ranks (``STORE`` a file the ranks rendezvous
on; rank r writes ``OUT_r.npz``; ``OMEGAS`` an npz of the fused
reference cases' Ω a step, ``<case>/<t>``)::

    python tests/_torch_mesh_worker.py RANK WORLD STORE OUT CKPT OMEGAS

Every case of ``MESH_CASES`` on its mesh of ``MESHES``, fields
``<case>/<run>/<field>`` with run ``mesh`` (the step over
the mesh, its parameters and moments stored by the specs) or ``clients``
(the step over ``ClientMesh(data size, group=the ranks of this model
index)``, everything whole): each step's metrics and reputation, the
final parameters and moments gathered whole, the local elements a rank
stores, a MoE step's kept (expert, token) pairs, and a reference case's
final parameters whole (``flat``); then
``launch.train --debug-mesh --smoke --steps 1 --strategy fused --ckpt
CKPT``.
"""
import hashlib
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

MESHES = {"4x1": (4, 1), "2x2": (2, 2)}
CLIP = 0.05            # small enough that the clip bites on every step
# name -> (the case of _torch_fl_step_worker.CASES whose config, weights
# and batches it takes, strategy, optimizer, mesh); the mixtral cases
# store their parameters over the data axis too (``fsdp``). Each mesh
# runs both strategies, each config both, AdamW with the clip on each
# strategy and without it on one; the fused MoE step on (2, 2), where the
# routing's group must be the ranks of one model index. The (4, 1) SGD
# cases are CASES' own steps, which the reference runs on that mesh
MESH_CASES = {
    "rg_two_phase": ("rg_two_phase", "two_phase", "sgd", "4x1"),
    "mixtral_fused_4x1": ("mixtral_fused", "fused", "sgd", "4x1"),
    "mixtral_two_phase": ("mixtral_fused", "two_phase", "adamw_clip", "2x2"),
    "rg_fused": ("rg_two_phase", "fused", "adamw", "2x2"),
    "mixtral_fused": ("mixtral_fused", "fused", "adamw_clip", "2x2"),
}
FIELDS = ("loss", "phi", "trust", "beta", "selected", "round_cost_units")


def of_reference(name: str) -> bool:
    """Whether the case is its CASES entry's own step (SGD, its strategy,
    4 clients on the (4, 1) mesh), which the reference's output holds."""
    from _torch_fl_step_worker import CASES

    base, strategy, kind, tag = MESH_CASES[name]
    return (kind, tag, strategy) == ("sgd", "4x1", CASES[base][4])


def case_cfg(name: str):
    from _torch_fl_step_worker import port_cfg

    cfg = port_cfg(MESH_CASES[name][0])
    return replace(cfg, fsdp=cfg.n_experts > 0)


def optimizer(kind: str):
    from repro_torch.optim import adamw, clip_by_global_norm, sgd

    if kind == "sgd":
        return sgd(0.05)
    init, update = adamw(0.01, weight_decay=0.1)
    if kind == "adamw":
        return init, update

    def clipped(grads, state, params):
        return update(clip_by_global_norm(grads, CLIP)[0], state, params)
    return init, clipped


def run(name: str, mesh, kept: list, omegas) -> dict:
    """Two chained steps of the case over ``mesh`` (a ``DeviceMesh`` or a
    ``ClientMesh``), a fused step's Ω from ``omegas`` where it holds the
    case's, else drawn from seeds 1, 2: each step's metrics and
    reputation, the final parameters and moments whole, this rank's
    stored elements."""
    from _torch_fl_step_worker import FL, LOSS_CHUNK, flat, inputs, tensors
    from repro_torch.configs.base import FLConfig
    from repro_torch.models.model import Model
    from repro_torch.sharding import full_tree
    from repro_torch.train import make_fl_train_step
    from repro_torch.tree import tree_leaves

    base, strategy, kind, _ = MESH_CASES[name]
    params, steps = inputs(base)
    opt = optimizer(kind)
    opt_state = opt[0](params)
    step, topo = make_fl_train_step(
        Model(case_cfg(name)), mesh, FLConfig(**FL), opt,
        strategy=strategy, loss_chunk=LOSS_CHUNK)
    rep = torch.full((topo.n_clients,), 1.0 / topo.n_clients)
    out = {}
    with step:
        for t, (batch, ref) in enumerate(steps):
            key = (() if strategy == "two_phase" else
                   (torch.tensor(omegas[f"{name}/{t}"]),)
                   if f"{name}/{t}" in omegas else (t + 1,))
            kept.clear()
            params, opt_state, rep, met = step(params, opt_state, rep,
                                               tensors(batch), tensors(ref),
                                               *key)
            out.update({f"{t}/{k}": met[k].numpy().copy() for k in FIELDS})
            out[f"{t}/rep"] = rep.numpy().copy()
            if kept:
                out[f"{t}/kept"] = np.concatenate(kept)

    def local(x):
        return x.to_local() if hasattr(x, "to_local") else x
    out["stored"] = np.array([sum(local(x).numel()
                                  for x in tree_leaves(params)),
                              sum(local(x).numel()
                                  for x in tree_leaves(opt_state.mu or []))])
    out["params"] = digest(full_tree(params))
    if of_reference(name):
        out["flat"] = flat(full_tree(params))
    if opt_state.mu is not None:
        out["moments"] = digest(full_tree([opt_state.mu, opt_state.nu]))
    out["step"] = np.asarray(int(opt_state.step))
    return out


def digest(tree) -> np.ndarray:
    """The SHA-1 of every leaf's bytes in tree order: equal digests are
    equal bits."""
    from repro_torch.tree import tree_leaves

    h = hashlib.sha1()
    for x in tree_leaves(tree):
        h.update(x.detach().contiguous().numpy().tobytes())
    return np.frombuffer(h.digest(), np.uint8)


def steps_fields(omegas) -> dict:
    from repro_torch.launch.mesh import live_mesh
    from repro_torch.models import moe
    from repro_torch.sharding import MeshShape
    from repro_torch.train import ClientMesh
    from repro_torch.sharding import clients_group

    kept = []
    real = moe.route

    def spy(combine, cap):
        rt = real(combine, cap)
        kept.append(np.stack([rt.expert.numpy(), rt.token.numpy()], 1))
        return rt
    moe.route = spy
    fields = {}
    try:
        for tag, shape in MESHES.items():
            mesh = live_mesh(MeshShape(("data", "model"), shape), "cpu")
            clients = ClientMesh(shape[0], group=clients_group(mesh))
            for name, case in MESH_CASES.items():
                if case[3] != tag:
                    continue
                for run_name, m in (("mesh", mesh), ("clients", clients)):
                    for k, v in run(name, m, kept, omegas).items():
                        fields[f"{name}/{run_name}/{k}"] = v
    finally:
        moe.route = real
    return fields


def launcher_fields(ckpt: str) -> dict:
    """``launch.train --debug-mesh`` (the (2, 2) debug mesh of 4 ranks:
    2 clients) on reduced gemma2-2b, one fused step, a checkpoint."""
    from repro_torch.launch import train

    res = train.main(["--smoke", "--steps", "1", "--strategy", "fused",
                      "--debug-mesh", "--device", "cpu", "--seq", "8",
                      "--batch", "2", "--ckpt", ckpt])
    return {"launcher/loss": res["metrics"]["loss"].numpy(),
            "launcher/rep": res["rep"].numpy()}


def main(argv) -> int:
    rank, world, store, out = int(argv[1]), int(argv[2]), argv[3], argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        fields = steps_fields(dict(np.load(argv[6])))
        fields.update(launcher_fields(argv[5]))
    finally:
        dist.destroy_process_group()
    np.savez(f"{out}_{rank}.npz", **fields)
    return 0


if __name__ == "__main__":
    here = Path(__file__).resolve().parent
    sys.path[:0] = [str(here), str(here.parent / "src")]
    sys.exit(main(sys.argv))
