"""The port's ``sharding`` (specs, storage by spec), ``launch.mesh`` and
``MeshTopology.from_mesh`` against the JAX reference on the CPU.

* ``Model.param_shapes`` against ``Model.init``: the same keys, shapes
  and dtypes, on the meta device;
* for all ten archs at full published width, ``param_specs`` and
  ``opt_state_specs`` against the reference's on ``AbstractMesh``es of
  the (16, 16), (2, 16, 16), (4, 1), (2, 2) and (1, 4) shapes, leaf for
  leaf after unstacking (a scanned group's spec loses its layer entry;
  the encoder's stack keeps it as ``Spec.layer``), exact;
* ``batch_specs``, ``tree_batch_specs`` and ``cache_specs`` at reduced
  configs, exact;
* each rank's slice under ``shard`` against ``NamedSharding(...).
  devices_indices_map`` on the (2, 2, 2) and (4, 2) meshes (8 host
  devices in a subprocess, nothing compiled; the port's 8 ranks on
  PyTorch's fake process group, nothing moved), and against DTensor's
  own local shape and offset;
* ``MeshTopology.from_mesh`` and the debug and production meshes'
  shapes against the reference's.
"""
import json
import os
import subprocess
import sys
import textwrap
from dataclasses import replace
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh
from jax.sharding import PartitionSpec as P

from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro.configs import get_arch as jget_arch
from repro.configs import reduced as jreduced
from repro.models.model import Model as JModel
from repro.optim import adamw as jadamw
from repro.sharding import specs as jspecs
from repro.train.steps import MeshTopology as JMeshTopology
from repro_torch.configs import ARCH_IDS, get_arch, reduced
from repro_torch.launch.mesh import (debug_mesh_shape, live_mesh,
                                     make_debug_mesh, make_production_mesh)
from repro_torch.models.model import Model
from repro_torch.models.transformer import layer_period
from repro_torch.optim import OptState, adamw
from repro_torch.sharding import (MeshShape, Spec, batch_specs, cache_specs,
                                  local_slices, opt_state_specs, param_specs,
                                  placements, shard, tree_batch_specs)
from repro_torch.train import MeshTopology
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((4, 1), ("data", "model")), ((2, 2), ("data", "model")),
          ((1, 4), ("data", "model"))]


def _is_p(x) -> bool:
    return isinstance(x, P)


def _unstack(tree, cfg):
    """The reference's spec tree in the port's layout: layer i of a
    scanned group takes the group's spec without its layer entry, a
    ``tail`` layer its own, each encoder layer the stack's spec with its
    first entry as ``Spec.layer``."""
    def scanned(s):
        return Spec(*tuple(s)[1:]) if len(s) else Spec()

    def stacked(s):
        return Spec(*tuple(s)[1:], layer=s[0]) if len(s) else Spec()

    p = layer_period(cfg)
    r = cfg.num_layers // p
    out = {k: Spec(*v) for k, v in tree.items()
           if k not in ("scanned", "tail", "encoder")}
    out["layers"] = [
        jax.tree.map(scanned, tree["scanned"][i % p], is_leaf=_is_p)
        if i < r * p else
        jax.tree.map(lambda s: Spec(*s), tree["tail"][i - r * p],
                     is_leaf=_is_p)
        for i in range(cfg.num_layers)]
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {
            "final_norm": Spec(*enc["final_norm"]),
            "layers": [jax.tree.map(stacked, enc["layers"], is_leaf=_is_p)
                       for _ in range(cfg.enc_layers)]}
    return out


def _paths(tree, pre=""):
    """(path, leaf) of a port tree whose leaves are tensors or Specs."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{pre}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{pre}/{i}")
    else:
        yield pre, tree


def _assert_same(got, want, what):
    g, w = list(_paths(got)), list(_paths(want))
    assert [p for p, _ in g] == [p for p, _ in w], what
    bad = [(p, a, b) for (p, a), (_, b) in zip(g, w) if a != b]
    assert not bad, (what, bad[:5])


# ---------------------------------------------------------------------------
# parameter shapes without weights

def test_param_shapes_match_init():
    """Every arch at reduced widths: the tree of ``Model.init`` leaf for
    leaf (keys, shapes, dtypes in fp32 and bf16), every leaf on the meta
    device."""
    for arch in ARCH_IDS:
        model = Model(reduced(get_arch(arch), d_model=64))
        for dtype in (torch.float32, torch.bfloat16):
            shapes = model.param_shapes(dtype)
            real = model.init(0, device="cpu", dtype=dtype)
            got, want = list(_paths(shapes)), list(_paths(real))
            assert [p for p, _ in got] == [p for p, _ in want], arch
            for (path, a), (_, b) in zip(got, want):
                assert a.shape == b.shape and a.dtype == b.dtype == dtype, \
                    (arch, path)
                assert a.device.type == "meta", (arch, path)


# ---------------------------------------------------------------------------
# param_specs / opt_state_specs at full width

def test_param_and_opt_state_specs_match_reference():
    """Every arch at full published width (llama4-maverick's ~394 B
    weights as meta tensors), every listed mesh: the port's
    ``param_specs`` and ``opt_state_specs`` (the moments' specs and the
    step's ``Spec()``) equal the reference's on ``jax.eval_shape`` of its
    ``Model.init``, leaf for leaf after unstacking; the parameter trees'
    shapes agree too."""
    for arch in ARCH_IDS:
        _param_and_opt_state_specs_match_reference(arch)


def _param_and_opt_state_specs_match_reference(arch):
    jcfg, cfg = jget_arch(arch), get_arch(arch)
    jshapes = jax.eval_shape(lambda k: JModel(jcfg).init(k),
                             jax.random.PRNGKey(0))
    jopt = jax.eval_shape(jadamw(1e-3)[0], jshapes)
    shapes = Model(cfg).param_shapes()
    ref_shapes = _unstack(jax.tree.map(lambda x: P(*x.shape), jshapes), cfg)
    for (path, got), (_, want) in zip(_paths(shapes), _paths(ref_shapes)):
        assert tuple(got.shape) == tuple(want), (arch, path)
    opt = adamw(1e-3)[0](shapes)
    for shape, names in MESHES:
        amesh, mesh = AbstractMesh(shape, names), MeshShape(names, shape)
        _assert_same(param_specs(shapes, cfg, mesh),
                     _unstack(jspecs.param_specs(jshapes, jcfg, amesh), cfg),
                     (arch, shape, "params"))
        got = opt_state_specs(opt, shapes, cfg, mesh)
        want = jspecs.opt_state_specs(jopt, jshapes, jcfg, amesh)
        assert got.step == Spec() and tuple(want.step) == ()
        for field in ("mu", "nu"):
            _assert_same(getattr(got, field),
                         _unstack(getattr(want, field), cfg),
                         (arch, shape, field))


def test_specs_judge_scanned_layers_at_their_stacked_size():
    """The 64 KiB rule reads a scanned layer at its group's stacked size
    and a tail layer at its own: the reduced recurrentgemma's period
    R, R repeats 12 times over 25 layers, so layers 0–23 are scanned and
    24 is its tail, and one layer's 64 x 64 RG-LRU gate (16 KiB) is
    sharded in the scanned layers (12 stacked: 192 KiB) and kept whole
    in the tail."""
    cfg = replace(reduced(get_arch("recurrentgemma-2b"), d_model=64),
                  num_layers=25)
    mesh = MeshShape(("data", "model"), (1, 4))
    specs = param_specs(Model(cfg).param_shapes(), cfg, mesh)
    w_a = [s["mixer"].get("w_a") for s in specs["layers"]]
    assert layer_period(cfg) == 2 and w_a[0] == Spec(None, "model")
    assert w_a[23] == w_a[0] and w_a[24] == Spec()
    jcfg = replace(jreduced(jget_arch("recurrentgemma-2b"), d_model=64),
                   num_layers=25)
    jshapes = jax.eval_shape(lambda k: JModel(jcfg).init(k),
                             jax.random.PRNGKey(0))
    _assert_same(specs, _unstack(jspecs.param_specs(
        jshapes, jcfg, AbstractMesh((1, 4), ("data", "model"))), cfg),
        "recurrentgemma 25 layers")


# ---------------------------------------------------------------------------
# batch and cache specs

def test_batch_and_cache_specs_match_reference():
    """Every arch at ``reduced(d_model=64)`` with each listed mesh and the
    debug meshes: ``batch_specs`` for batch sizes that do and do not
    split, ``tree_batch_specs`` of ``dummy_batch``'s leaves and
    ``cache_specs`` of ``init_cache`` (batch 1, 4 and 32; a batch that
    does not split shards the sequence) against the reference's."""
    for arch in ARCH_IDS:
        _batch_and_cache_specs_match_reference(arch)


def _batch_and_cache_specs_match_reference(arch):
    cfg = reduced(get_arch(arch), d_model=64)
    jcfg = jreduced(jget_arch(arch), d_model=64)
    model, jmodel = Model(cfg), JModel(jcfg)
    params = model.init(0, device="cpu")
    jshapes = jax.eval_shape(lambda k: jmodel.init(k), jax.random.PRNGKey(0))
    meshes = MESHES + [((8, 1), ("data", "model")),
                       ((2, 2, 2), ("pod", "data", "model"))]
    for shape, names in meshes:
        amesh, mesh = AbstractMesh(shape, names), MeshShape(names, shape)
        for b in (1, 3, 4, 16, 32, 512):
            assert batch_specs(cfg, mesh, b) == jspecs.batch_specs(
                jcfg, amesh, b), (arch, shape, b)
        batch = model.dummy_batch(0, batch=4, seq=cfg.vis_tokens + 8)
        jbatch = jax.tree.map(lambda x: jax.ShapeDtypeStruct(
            tuple(x.shape), np.float32), batch)
        got = tree_batch_specs(batch, cfg, mesh)
        want = jspecs.tree_batch_specs(jbatch, jcfg, amesh)
        assert {k: tuple(v) for k, v in got.items()} == \
            {k: tuple(v) for k, v in want.items()}, (arch, shape)
        for b in (1, 4, 32):
            cache = model.init_cache(params, b, 64)
            jcache = jax.eval_shape(
                lambda p, b=b: jmodel.init_cache(p, b, 64), jshapes)
            want = jspecs.cache_specs(jcache, jcfg, amesh, b)
            _assert_same(cache_specs(cache, cfg, mesh, b),
                         {"layers": _unstack(dict(want), cfg)["layers"]},
                         (arch, shape, b))


# ---------------------------------------------------------------------------
# storage by spec

def test_placements_follow_the_entries():
    """An axis on a dim puts ``Shard(dim)`` on that mesh dim, a tuple
    entry on each of its axes, the rest ``Replicate``; axes against the
    mesh's order, unknown or used twice are refused."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = MeshShape(("pod", "data", "model"), (2, 2, 2))
    assert placements(Spec(("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert placements(Spec(), mesh) == [Replicate()] * 3
    assert placements(Spec(None, "data"), mesh) == [
        Replicate(), Shard(1), Replicate()]
    for bad, match in ((Spec(("data", "pod")), "against the mesh's order"),
                       (Spec("expert"), "names axis 'expert'"),
                       (Spec("data", "data"), "uses axis 'data' twice")):
        with pytest.raises(ValueError, match=match):
            placements(bad, mesh)
    with pytest.raises(ValueError, match="does not split into 4"):
        local_slices((6, 2), Spec(("pod", "data")), mesh,
                     {"pod": 0, "data": 0, "model": 0})


_INDEX_MAP = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.launch.mesh import make_debug_mesh

    spec = json.loads(sys.argv[1])
    out = {"maps": [], "debug": {}}
    for case in spec:
        mesh = jax.make_mesh(tuple(case["mesh"]), tuple(case["names"]))
        ent = [tuple(e) if isinstance(e, list) else e
               for e in case["entries"]]
        idx = NamedSharding(mesh, P(*ent)).devices_indices_map(
            tuple(case["shape"]))
        by = {}
        for coord in np.ndindex(mesh.devices.shape):
            sl = idx[mesh.devices[coord]]
            by[",".join(map(str, coord))] = [
                [s.start or 0, n if s.stop is None else s.stop]
                for s, n in zip(sl, case["shape"])]
        out["maps"].append(by)
    for n in (1, 2, 4, 8):
        for mp in (False, True):
            m = make_debug_mesh(n, mp)
            out["debug"][f"{n},{int(mp)}"] = [list(m.axis_names),
                                              list(m.devices.shape)]
    print(json.dumps(out))
""")


def _storage_cases():
    """(mesh shape, names, leaf shape, spec entries): every distinct
    param and moment spec of reduced mixtral and gemma2 (fsdp) on the
    (2, 2, 2) and (4, 2) meshes, and a few tuple entries by hand."""
    cases = []
    for shape, names in (((2, 2, 2), ("pod", "data", "model")),
                         ((4, 2), ("data", "model"))):
        mesh = MeshShape(names, shape)
        seen = set()
        for arch in ("mixtral-8x7b", "gemma2-2b"):
            cfg = replace(reduced(get_arch(arch), d_model=128), fsdp=True)
            shapes = Model(cfg).param_shapes()
            for specs in (param_specs(shapes, cfg, mesh),
                          opt_state_specs(OptState(None, shapes, None),
                                          shapes, cfg, mesh).mu):
                for x, s in zip(tree_leaves(shapes), tree_leaves(specs)):
                    key = (tuple(x.shape), tuple(s))
                    if key not in seen:
                        seen.add(key)
                        cases.append((shape, names) + key)
        daxes = names[:-1]
        tup = daxes if len(daxes) > 1 else daxes[0]
        cases += [(shape, names, (16, 8), (tup, "model")),
                  (shape, names, (8, 16, 4), (None, tup, None)),
                  (shape, names, (8, 6), ("model", None))]
    return cases


@pytest.fixture(scope="module")
def reference_maps():
    cases = _storage_cases()
    arg = json.dumps([dict(mesh=c[0], names=c[1], shape=c[2],
                           entries=[list(e) if isinstance(e, tuple) else e
                                    for e in c[3]]) for c in cases])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _INDEX_MAP, arg], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return cases, json.loads(proc.stdout.splitlines()[-1])


def test_each_ranks_shard_is_the_reference_devices_slice(reference_maps):
    """For every rank of the (2, 2, 2) and (4, 2) meshes (8 ranks of
    PyTorch's fake process group, one after another; rank r at
    row-major mesh position r), the local tensor ``shard`` stores of a
    tensor of distinct values is the slice the reference's
    ``devices_indices_map`` gives the device at the same mesh
    coordinate, and DTensor's own local shape and offset say the
    same."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.testing._internal.distributed.fake_pg import FakeStore

    cases, ref = reference_maps
    assert len(cases) == len(ref["maps"]) > 20
    for rank in range(8):
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=8)
        try:
            meshes = {}
            for (mshape, names, shape, entries), want in zip(cases,
                                                             ref["maps"]):
                key = (tuple(mshape), tuple(names))
                if key not in meshes:
                    meshes[key] = live_mesh(MeshShape(names, mshape), "cpu")
                mesh = meshes[key]
                coord = tuple(int(c) for c in mesh.get_coordinate())
                x = torch.arange(int(np.prod(shape)),
                                 dtype=torch.float32).reshape(shape)
                spec = Spec(*entries)
                local = shard(x, spec, mesh).to_local()
                sl = want[",".join(map(str, coord))]
                assert torch.equal(local, x[tuple(slice(a, b)
                                                  for a, b in sl)]), \
                    (mshape, shape, entries, coord)
                lshape, offset = compute_local_shape_and_global_offset(
                    tuple(shape), mesh, placements(spec, mesh))
                assert list(lshape) == [b - a for a, b in sl]
                assert list(offset) == [a for a, _ in sl]
        finally:
            dist.destroy_process_group()


def test_debug_and_production_mesh_shapes_match_reference(reference_maps):
    """``debug_mesh_shape(n, multi_pod)`` is the reference's
    ``make_debug_mesh(n, multi_pod)``'s shape for 1, 2, 4 and 8 devices;
    the production meshes are the reference's 16 x 16 and 2 x 16 x 16."""
    _, ref = reference_maps
    for key, (names, shape) in ref["debug"].items():
        n, mp = (int(v) for v in key.split(","))
        got = debug_mesh_shape(n, bool(mp))
        assert (list(got.axis_names), list(got.sizes)) == (names, shape)
    assert make_production_mesh() == MeshShape(("data", "model"), (16, 16))
    assert make_production_mesh(multi_pod=True) == MeshShape(
        ("pod", "data", "model"), (2, 16, 16))


def test_live_meshes_on_one_rank():
    """Without a group, ``make_debug_mesh(device="cpu")`` starts a
    one-rank gloo group and gives the (1, 1) mesh (the caller ends the
    group); a live production mesh on one rank, or a debug mesh of more
    ranks than the group holds, is refused in plain words."""
    assert not dist.is_initialized()
    mesh = make_debug_mesh(device="cpu")
    try:
        assert dist.get_world_size() == 1
        assert tuple(mesh.mesh_dim_names) == ("data", "model")
        assert tuple(mesh.shape) == (1, 1) and mesh.device_type == "cpu"
        topo = MeshTopology.from_mesh(mesh, 2)
        assert (topo.n_clients, topo.n_clouds) == (1, 1)
        with pytest.raises(ValueError, match="needs 256 ranks, one a chip"):
            make_production_mesh(device="cpu")
        with pytest.raises(ValueError, match="holds 4 ranks; this process "
                                             "group has 1"):
            make_debug_mesh(4, device="cpu")
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the topology

TOPOLOGIES = [
    ((4, 1), ("data", "model"), 2), ((2, 2), ("data", "model"), None),
    ((16, 16), ("data", "model"), None), ((6,), ("data",), 4),
    ((2, 16, 16), ("pod", "data", "model"), 2),
    ((2, 2, 2), ("pod", "data", "model"), 5),
    ((3, 2, 1), ("pod", "data", "model"), None),
    ((1, 4), ("data", "model"), 3)]


def test_mesh_topology_from_mesh_matches_reference():
    """On each of ``TOPOLOGIES`` (shape, axis names, ``n_clouds``): every
    field, ``cloud_of`` and ``unit_costs`` against the reference's,
    single-pod (clouds by the divisor rule) and multi-pod (clouds = pods,
    whatever ``n_clouds`` says)."""
    for shape, names, n_clouds in TOPOLOGIES:
        what = (shape, names, n_clouds)
        want = JMeshTopology.from_mesh(AbstractMesh(shape, names), n_clouds)
        got = MeshTopology.from_mesh(MeshShape(names, shape), n_clouds)
        for field in ("daxes", "n_clients", "n_clouds", "clients_per_cloud",
                      "pod_aligned"):
            assert getattr(got, field) == getattr(want, field), (what, field)
        assert np.array_equal(got.cloud_of(), want.cloud_of()), what
        for agg in (0, got.n_clouds - 1):
            assert np.array_equal(got.unit_costs(0.01, 0.09, agg),
                                  want.unit_costs(0.01, 0.09, agg)), what
