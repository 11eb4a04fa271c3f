"""The port's federated train steps over a ``DeviceMesh`` on 4 spawned
gloo ranks (``tests/_torch_mesh_worker.py``), against the same steps
over a ``ClientMesh`` on the ranks of one model index: the (4, 1) mesh
(4 clients) and the (2, 2) mesh (2 clients, each computed twice along
``model``), reduced recurrentgemma and mixtral (the latter storing its
parameters over the data axis too, as ``fsdp``), both strategies, SGD,
AdamW and AdamW after ``clip_by_global_norm``; then ``launch.train
--debug-mesh`` over the same ranks.

Everything is held bit for bit: gloo sums in the same order whatever
the storage, the gathered parameters are the same bits, and AdamW's
update is element-wise, so a rank updating its slice computes the bits
the whole update computes there; the clip reads the whole gradient.
The (4, 1) SGD cases are ``tests/test_torch_fl_steps.py``'s own steps,
and are also held to the reference's output there (its ``reference``
fixture, one run a session; the fused case replays the reference's Ω),
within that file's bounds.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_mesh_worker import MESH_CASES, MESHES, case_cfg, of_reference
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from test_torch_fl_steps import hold_to_reference
from test_torch_fl_steps import reference  # noqa: F401 (fixture)
from repro_torch.models.model import Model
from repro_torch.optim import OptState
from repro_torch.sharding import (MeshShape, local_slices, opt_state_specs,
                                  param_specs)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

WORKER = Path(__file__).resolve().parent / "_torch_mesh_worker.py"
WORLD = 4


def _spawn(work: Path, omegas: Path) -> list:
    """The 4 ranks' npz fields (a time limit each, past which the test
    fails)."""
    out = work / "rank"
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(WORLD),
         str(work / "store"), str(out), str(work / "ckpt"), str(omegas)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0].decode()[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), logs
    return [dict(np.load(f"{out}_{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, reference):
    """(every rank's fields, the launcher's checkpoint directory). Under
    pytest-xdist the workers of one session share one run (the first to
    take the lock spawns the ranks into the session's temporary root).
    The fused reference cases take the reference's Ω."""
    from filelock import FileLock

    shared = os.environ.get("PYTEST_XDIST_WORKER") is not None
    root = (tmp_path_factory.getbasetemp().parent if shared
            else tmp_path_factory.mktemp("mesh"))
    work = root / "mesh_steps"
    with FileLock(str(root / "mesh_steps.lock")):
        if not (work / "done").exists():
            work.mkdir(exist_ok=True)
            omegas = {f"{case}/{t}": step["omega"]
                      for case, (base, strategy, *_) in MESH_CASES.items()
                      if of_reference(case) and strategy == "fused"
                      for t, step in enumerate(reference[base]["steps"])}
            np.savez(work / "omegas.npz", **omegas)
            _spawn(work, work / "omegas.npz")
            (work / "done").touch()
    ranks = [dict(np.load(work / f"rank_{r}.npz")) for r in range(WORLD)]
    return ranks, work / "ckpt"


def _run(fields: dict, case: str, run: str) -> dict:
    pre = f"{case}/{run}/"
    return {k[len(pre):]: v for k, v in fields.items() if k.startswith(pre)}


def _coords(shape, rank: int) -> dict:
    return dict(zip(("data", "model"), np.unravel_index(rank, shape)))


def _stored(specs, shapes, mesh: MeshShape, coord: dict) -> int:
    """Elements a rank at ``coord`` stores of ``shapes`` under ``specs``."""
    sizes = [int(np.prod([s.stop - s.start for s in
                          local_slices(x.shape, spec, mesh, coord)]))
             for x, spec in zip(tree_leaves(shapes), tree_leaves(specs))]
    return sum(sizes)


@pytest.mark.parametrize("case", sorted(MESH_CASES))
def test_mesh_step_equals_client_mesh_step(case, spawned):
    """On every rank, two chained steps over the mesh (parameters by
    ``param_specs``, moments by ``opt_state_specs``) give the bits of the
    same steps over ``ClientMesh(data size)`` on the rank's model index
    (everything whole): metrics, reputation, selection, the gathered
    parameters and moments (SHA-1 digests) and the step counter; and
    each rank stores exactly its spec-given slices."""
    ranks, _ = spawned
    tag = MESH_CASES[case][3]
    mesh = MeshShape(("data", "model"), MESHES[tag])
    cfg = case_cfg(case)
    shapes = Model(cfg).param_shapes()
    for rank, fields in enumerate(ranks):
        got, want = _run(fields, case, "mesh"), _run(fields, case, "clients")
        assert set(got) == set(want) and len(got) > 10
        for key, w in want.items():
            if key != "stored":
                assert np.array_equal(got[key], w), (rank, key)
        coord = _coords(MESHES[tag], rank)
        pspecs = param_specs(shapes, cfg, mesh)
        ospecs = opt_state_specs(OptState(None, shapes, shapes), shapes, cfg,
                                 mesh)
        whole = sum(x.numel() for x in tree_leaves(shapes))
        moments = 0 if MESH_CASES[case][2] == "sgd" else 2
        assert list(want["stored"]) == [whole, whole * (moments > 0)]
        assert list(got["stored"]) == [
            _stored(pspecs, shapes, mesh, coord),
            _stored(ospecs.mu, shapes, mesh, coord) * (moments > 0)]


@pytest.mark.parametrize("case", sorted(c for c in MESH_CASES
                                         if of_reference(c)))
def test_mesh_step_matches_reference(case, spawned, reference):
    """On every rank, the (4, 1) mesh's two SGD steps (parameters stored
    by ``param_specs``, over the data axis too for mixtral) against the
    reference's same steps on its (4, 1) mesh, as
    ``test_world_size_one_matches_reference`` holds the one-rank step:
    the mask exact, the cost units within 1e-6, the loss, φ, trust, β and
    reputation within 1e-5 relative, every parameter leaf and the update
    within 1e-4."""
    from _torch_fl_step_worker import METRICS, STEPS

    ranks, _ = spawned
    base = MESH_CASES[case][0]
    shapes = Model(case_cfg(case)).param_shapes()
    for fields in ranks:
        got = _run(fields, case, "mesh")
        recs = [{k: got[f"{t}/{k}"] for k in METRICS + ("rep",)}
                for t in range(STEPS)]
        flat, leaves = got["flat"], []
        for x in tree_leaves(shapes):
            leaves.append(torch.from_numpy(flat[:x.numel()].copy())
                          .reshape(x.shape))
            flat = flat[x.numel():]
        assert flat.size == 0
        hold_to_reference(base, recs, tree_unflatten(shapes, leaves),
                          reference[base])


def test_zero1_and_fsdp_store_less_than_whole(spawned):
    """The moments of every AdamW case are stored in slices (ZeRO-1: less
    than whole on every rank; the reduced recurrentgemma keeps most of
    its small leaves whole), mixtral's parameters and moments too
    (fsdp: under half), and a (2, 2) rank holds a quarter of a mixtral
    expert stack (model x data)."""
    ranks, _ = spawned
    for case, (_, _, kind, tag) in MESH_CASES.items():
        for fields in ranks:
            got = _run(fields, case, "mesh")["stored"]
            whole = _run(fields, case, "clients")["stored"][0]
            if kind != "sgd":
                assert got[1] < whole, (case, got)
            if case.startswith("mixtral"):
                assert max(got) < whole / 2, (case, got)
    cfg = case_cfg("mixtral_fused")
    shapes = Model(cfg).param_shapes()
    mesh = MeshShape(("data", "model"), (2, 2))
    w_up = shapes["layers"][0]["ffn"]["w_up"]
    spec = param_specs(shapes, cfg, mesh)["layers"][0]["ffn"]["w_up"]
    assert set(spec) == {None, "model", "data"}
    sl = local_slices(w_up.shape, spec, mesh, {"data": 1, "model": 1})
    assert np.prod([s.stop - s.start for s in sl]) * 4 == w_up.numel()


def test_model_axis_replicas_agree(spawned):
    """On (2, 2), the two ranks of each data index (model 0 and 1)
    return the same bits: metrics, reputation, parameters, moments."""
    ranks, _ = spawned
    for case, (_, _, _, tag) in MESH_CASES.items():
        if tag != "2x2":
            continue
        for a, b in ((0, 1), (2, 3)):
            ga, gb = _run(ranks[a], case, "mesh"), _run(ranks[b], case,
                                                       "mesh")
            for key in ga:
                if key != "stored" and not key.endswith("kept"):
                    assert np.array_equal(ga[key], gb[key]), (case, key)


def test_moe_routes_over_the_ranks_of_one_model_index(spawned):
    """The fused mixtral step on (2, 2) routes each MoE layer over the
    global batch of its model index's 2 ranks (the routing group is the
    clients' ranks, not all 4): its kept (expert, token) pairs equal
    ``ClientMesh(2)``'s, and the token indices span 2 ranks' rows, not
    4."""
    from _torch_fl_step_worker import PER, SEQ, N_CLIENTS

    ranks, _ = spawned
    rows = N_CLIENTS * PER                   # the global batch
    for fields in ranks:
        got = _run(fields, "mixtral_fused", "mesh")
        want = _run(fields, "mixtral_fused", "clients")
        for t in (0, 1):
            kept = got[f"{t}/kept"]
            assert np.array_equal(kept, want[f"{t}/kept"])
            assert len(kept) and kept[:, 1].max() < rows * SEQ
            # the signature and the backward forwards see both ranks'
            # halves: global tokens from each half are kept
            assert kept[:, 1].min() < rows * SEQ // 2 <= kept[:, 1].max()


def test_launcher_debug_mesh_saves_whole_tensors(spawned):
    """``launch.train --debug-mesh --smoke --steps 1 --strategy fused``
    over the 4 ranks (the (2, 2) debug mesh: 2 clients): the loss
    finite and equal on every rank, and its checkpoint holds every
    parameter whole, in the shapes of ``Model.init``, restored."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.models.model import build_model

    ranks, ckpt = spawned
    losses = [float(r["launcher/loss"]) for r in ranks]
    assert np.isfinite(losses[0]) and len(set(losses)) == 1
    assert all(np.array_equal(r["launcher/rep"], ranks[0]["launcher/rep"])
               for r in ranks) and ranks[0]["launcher/rep"].shape == (2,)
    model = build_model("gemma2-2b", smoke=True)
    like = {"params": tree_map(lambda x: torch.zeros(x.shape),
                               model.param_shapes()),
            "rep": torch.zeros(2)}
    tree, meta = restore_checkpoint(str(ckpt), like)
    assert meta["step"] == 1
    for got, want in zip(tree_leaves(tree["params"]),
                         tree_leaves(model.param_shapes())):
        assert got.shape == want.shape and torch.isfinite(got).all()
    assert np.allclose(tree["rep"].numpy(), ranks[0]["launcher/rep"])


def test_mesh_worker_imports_neither_jax_nor_reference():
    """The spawned ranks' code is the port's alone."""
    import ast

    tree = ast.parse(WORKER.read_text())
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names]
    names += [node.module or "" for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom)]
    assert not [n for n in names if n.split(".")[0] in ("jax", "repro")]


def test_a_new_mesh_of_one_layout_after_its_group_ended():
    """Two live (1, 1) meshes in turn, each over a one-rank gloo group
    that is ended after its step (the two compare equal as
    ``DeviceMesh``es, and the first outlives its group): a fused step over
    each runs on groups of its own world and gives the same bits. The
    steps' intra- and cross-cloud groups belong to the mesh object, not
    to its layout."""
    import torch.distributed as dist
    from repro_torch.configs import get_arch, reduced
    from repro_torch.configs.base import FLConfig
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.optim import adamw
    from repro_torch.sharding import full_tree
    from repro_torch.train import make_fl_train_step

    model = Model(reduced(get_arch("gemma2-2b"), d_model=32, layers=1))
    batch = model.dummy_batch(1, 2, 8)
    ref = {k: v[None] for k, v in model.dummy_batch(2, 1, 8).items()}
    meshes, runs = [], []
    for _ in range(2):
        meshes.append(make_debug_mesh(1, device="cpu"))
        try:
            opt = adamw(1e-2)
            params = model.init(0, device="cpu")
            step, _ = make_fl_train_step(
                model, meshes[-1], FLConfig(n_clouds=1, clients_per_round=1),
                opt, strategy="fused", loss_chunk=8)
            with step:
                params, _, rep, met = step(params, opt[0](params),
                                           torch.ones(1), batch, ref, 1)
                # groups of this process group's world (a group of an
                # ended one is unknown to it: NCCL aborts a collective)
                for g in (step._ranks.client_group, step._ranks.cloud_group):
                    assert dist.get_process_group_ranks(g) == [0]
            runs.append([met["loss"], rep] + tree_leaves(full_tree(params)))
        finally:
            dist.destroy_process_group()
    assert meshes[0] == meshes[1] and meshes[0] is not meshes[1]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
