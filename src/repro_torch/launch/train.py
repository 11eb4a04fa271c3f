"""Federated training launcher: Cost-TrustFL train steps of any
registered ``--arch`` (the port's copy of ``repro/launch/train.py``),
each with its config's ``fl_strategy`` unless ``--strategy`` says
otherwise; a VLM's batch carries its ``patches`` and an
encoder-decoder's its ``frames`` (``Model.dummy_batch``), and a VLM's
``--seq`` counts the image tokens before the text.

The clients lie over the ranks of ``torch.distributed``'s default group:
the one ``torchrun`` starts (its environment read here; each rank takes
its local card), or a one-rank group started here or by the step. With
``--debug-mesh`` (``--multi-pod``: a pod axis, clouds = pods, from 8
ranks) they lie on the data axes of ``launch.mesh.make_debug_mesh`` over
those ranks, one client a data index, with parameters and AdamW's
moments stored by the reference's ``param_specs`` / ``opt_state_specs``.
Without it, ``--clients`` (default 4: the data axis of the reference's
8-device debug mesh) gives the client count (a ``ClientMesh``), and
``--multi-pod`` asks for the production mesh, which needs 512 ranks. The
reference's unused ``--shape`` is dropped. ``--ckpt`` saves whole
tensors, so a checkpoint reads the same whatever the mesh.

  python -m repro_torch.launch.train --arch gemma2-2b --smoke --steps 10 \\
      --device cpu
  python -m repro_torch.launch.train --arch paligemma-3b --smoke \\
      --steps 1 --device cpu
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch \\
      recurrentgemma-2b --smoke
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch \\
      mixtral-8x7b --smoke --debug-mesh
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs.base import FLConfig
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.models.model import build_model
from repro_torch.optim import adamw
from repro_torch.sharding import (full_tree, opt_state_specs, param_specs,
                                  shard_tree)
from repro_torch.train import ClientMesh, make_fl_train_step


def _torchrun_group(device: str) -> Optional[str]:
    """Join the group ``torchrun`` describes in the environment (none:
    ``None``); returns this rank's device."""
    if "RANK" not in os.environ or dist.is_initialized():
        return None
    cuda = torch.device(device).type == "cuda"
    dist.init_process_group("cpu:gloo,cuda:nccl" if cuda else "gloo")
    if not cuda:
        return device
    local = int(os.environ.get("LOCAL_RANK", 0))
    torch.cuda.set_device(local)
    return f"cuda:{local}"


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--strategy", default=None,
                    choices=[None, "two_phase", "fused"])
    ap.add_argument("--smoke", action="store_true",
                    help="reduced model config (CPU-sized)")
    ap.add_argument("--debug-mesh", action="store_true",
                    help="the clients on the data axes of a small mesh "
                         "over the ranks that exist")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--n-clouds", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    model = build_model(args.arch, smoke=args.smoke)
    vis = model.cfg.vis_tokens
    if args.seq <= vis:
        raise ValueError(f"--seq {args.seq} leaves no text after the {vis} "
                         f"image tokens of {args.arch}: give --seq > {vis}")
    joined = _torchrun_group(args.device)
    device = resolve_device(joined or args.device)
    started = False
    if args.debug_mesh:
        started = not dist.is_initialized()
        mesh = make_debug_mesh(multi_pod=args.multi_pod, device=device)
    elif args.multi_pod:
        mesh = make_production_mesh(multi_pod=True, device=device)
    else:
        mesh = ClientMesh(args.clients)
    lead = not dist.is_initialized() or dist.get_rank() == 0
    fl = FLConfig(n_clouds=args.n_clouds, clients_per_round=4)
    opt = adamw(args.lr)
    strategy = args.strategy or model.cfg.fl_strategy
    step, topo = make_fl_train_step(model, mesh, fl, opt, strategy=strategy)
    if args.batch % topo.n_clients:
        raise ValueError(f"--batch {args.batch} does not split over "
                         f"{topo.n_clients} clients")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if lead:
        where = ("" if isinstance(mesh, ClientMesh)
                 else f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} ")
        print(f"{where}ranks={world} clients={topo.n_clients} "
              f"clouds={topo.n_clouds} strategy={strategy}", flush=True)

    params = model.init(0, device=device)
    if isinstance(mesh, ClientMesh):
        opt_state = opt[0](params)
    else:
        # stored where the step keeps them, the moments made in place
        shapes = model.param_shapes()
        params = shard_tree(params, param_specs(shapes, model.cfg, mesh),
                            mesh)
        mu_specs = opt_state_specs(opt[0](shapes), shapes, model.cfg,
                                   mesh).mu
        opt_state = opt[0](shard_tree(params, mu_specs, mesh))
    rep = torch.full((topo.n_clients,), 1.0 / topo.n_clients, device=device)
    met = {}
    t0 = time.time()
    try:
        for it in range(args.steps):
            batch = model.dummy_batch(2 * it, batch=args.batch, seq=args.seq,
                                      device=device)
            ref = model.dummy_batch(2 * it + 1, batch=topo.n_clouds * 2,
                                    seq=args.seq, device=device)
            ref = {k: v.reshape((topo.n_clouds, 2) + tuple(v.shape[1:]))
                   for k, v in ref.items()}
            extra = (it,) if strategy == "fused" else ()
            params, opt_state, rep, met = step(params, opt_state, rep, batch,
                                               ref, *extra)
            if lead:
                print(f"step {it + 1:3d} loss={float(met['loss']):.4f} "
                      f"rep={np.array2string(rep.cpu().numpy(), precision=3)}"
                      f" ({(time.time() - t0) / (it + 1):.2f}s/step)",
                      flush=True)
        params = full_tree(params)
    finally:
        step.close()
        if joined is not None or started:
            dist.destroy_process_group()
    if args.ckpt and lead:
        save_checkpoint(args.ckpt, {"params": params, "rep": rep},
                        step=args.steps, metadata={"arch": args.arch})
        print("checkpoint ->", args.ckpt)
    return {"params": params, "rep": rep, "metrics": met}


if __name__ == "__main__":
    main()
