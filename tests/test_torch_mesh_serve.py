"""The port's serve steps over a ``DeviceMesh`` on 4 spawned gloo ranks
(``tests/_torch_mesh_serve_worker.py``): ``Model.prefill``,
``make_serve_step`` and ``make_prefill_step`` with weights stored by
``param_specs`` (drawn so), caches by ``cache_specs`` and tokens by
``batch_specs``, computing tensor-parallel over ``model`` and splitting
the batch (or, at batch 1, the cache's sequence) over ``data``, on the
(4, 1), (2, 2) and (1, 4) meshes for reduced gemma2-2b, mixtral (stored
over the data axis too, ``fsdp``), llama4, a dense config whose KV
heads fall to D (row-parallel), recurrentgemma-2b's RG-LRU and local
attention, rwkv6-1.6b and whisper-small's encoder and cross-attention
(test configs cut on the published configs' dims), and for paligemma's
decoder with its image prefix through ``make_prefill_step``; held
against the port's one-device steps on every rank and against the
reference's ``make_serve_step`` / ``make_prefill_step`` on the same
meshes, run by XLA on the CPU in a subprocess with forced host devices
(``reference`` fixture), which also reads the reference's ``constrain``
under ``jax.set_mesh`` for a table of shapes.

Three items on purpose: their checks loop inside them, so the suite's
count of collected items (and with it xdist's first hand-out) stays as
it is plus three.
"""
import os
import pickle
import subprocess
import sys
import textwrap
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

from _torch_mesh_serve_worker import (CASES, MAX_LEN, PROMPT, PUBLISHED,
                                      REFERENCE_RUNS, RUNS, STEPS, case_cfg,
                                      case_seed, prefill_inputs, run_name)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.models.model import Model
from repro_torch.sharding import (MeshShape, cache_specs, constrain_spec,
                                  local_slices, param_specs)
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_torch_mesh_serve_worker.py"
WORLD = 4


def _shared_dir(tmp_path_factory, name: str) -> Path:
    """The session's temporary root under pytest-xdist (its workers share
    one run of a fixture), else a directory of this module's."""
    shared = os.environ.get("PYTEST_XDIST_WORKER") is not None
    return (tmp_path_factory.getbasetemp().parent if shared
            else tmp_path_factory.mktemp(name))


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Every rank's fields (the first xdist worker to take the lock spawns
    the ranks, a 300 s limit each; the others read their output)."""
    from filelock import FileLock

    root = _shared_dir(tmp_path_factory, "mesh_serve")
    work = root / "mesh_serve"
    with FileLock(str(root / "mesh_serve.lock")):
        if not (work / "done").exists():
            work.mkdir(exist_ok=True)
            procs = [subprocess.Popen(
                [sys.executable, str(WORKER), str(r), str(WORLD),
                 str(work / "store"), str(work / "rank")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                for r in range(WORLD)]
            logs = []
            try:
                for p in procs:
                    logs.append(p.communicate(timeout=300)[0].decode()[-3000:])
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            assert all(p.returncode == 0 for p in procs), logs
            (work / "done").touch()
    return [dict(np.load(work / f"rank_{r}.npz")) for r in range(WORLD)]


def _coord(shape, rank: int) -> dict:
    return dict(zip(("data", "model"), np.unravel_index(rank, shape)))


def _stored(specs, shapes, mesh: MeshShape, coord: dict) -> int:
    return sum(int(np.prod([s.stop - s.start for s in
                            local_slices(x.shape, spec, mesh, coord)]))
               for x, spec in zip(tree_leaves(shapes), tree_leaves(specs)))


def _rel_max(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def _rel(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _cut_dims(cfg, shape, batch: int) -> dict:
    """{(tree, layer type or "enc", leaf path): the set of the non-whole
    specs the rules give that leaf} of ``cfg``'s params and cache on the
    (data, model) mesh ``shape`` at ``batch``."""
    mesh = MeshShape(("data", "model"), shape)
    model = Model(cfg)
    shapes = model.param_shapes()
    cshapes = model.init_cache({"embed": shapes["embed"], "layers": []},
                               batch, MAX_LEN)
    types = cfg.layer_types()
    out: dict = {}

    def walk(tree, path, tag):
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], path + (k,), tag)
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                walk(v, path + (i,), tag)
        else:
            ent = tuple(tree)
            if any(e is not None for e in ent) or tree.layer is not None:
                if path[0] == "layers":
                    key = (tag, types[path[1]]) + path[2:]
                elif path[:2] == ("encoder", "layers"):
                    key = (tag, "enc") + path[3:]
                else:
                    key = (tag,) + path
                out.setdefault(key, set()).add((ent, tree.layer))
    walk(param_specs(shapes, cfg, mesh), (), "params")
    walk(cache_specs(cshapes, cfg, mesh, batch), (), "cache")
    return out


def _own_experts(cfg, shape, rank: int) -> set:
    """The experts a rank's stacks hold (their E dim cut over ``model``
    where the rules cut it)."""
    mesh = MeshShape(("data", "model"), shape)
    shapes = Model(cfg).param_shapes()
    specs = param_specs(shapes, cfg, mesh)
    lp = next(i for i in range(cfg.num_layers) if cfg.is_moe_layer(i))
    sl = local_slices(shapes["layers"][lp]["ffn"]["w_up"].shape,
                      specs["layers"][lp]["ffn"]["w_up"], mesh,
                      _coord(shape, rank))[0]
    return set(range(sl.start, sl.stop))


def test_mesh_serve_equals_one_device_step(spawned):
    """On every rank and run: the mesh's prefill logits, the
    ``make_prefill_step`` logits and ``STEPS`` greedy steps' logits within
    1e-5 of max |logit| of the one-device steps', the greedy tokens
    exact, the caches (after the prefill and after the steps, gathered
    whole) within 1e-6 relative (‖Δ‖ / ‖cache‖) with every position
    exact; the weights drawn over the mesh the bits of ``shard_tree`` of
    the whole draw; every rank storing exactly its spec-given elements of
    the weights and of the cache. Without MoE, a rank's matmul FLOPs in
    one decode step are at most 1.1 × the one device's over the ranks
    that share it: the model axis's, times the data axis's where the
    batch splits over it (at batch 1 over data, whole weights compute
    whole on each data rank; the decode step runs no encoder, whose
    attention every model rank computes whole); a MoE rank computes only
    its own experts, and the ranks that share a batch block compute each
    expert's rows of the one-device step between them. The recurrent
    and encoder-decoder test configs' leaves and caches are cut on the
    dims of the published configs' (``PUBLISHED``: the depths that give
    the published spec trees, the leaves they keep whole named). Then
    what the mesh steps refuse (whole params too), and ``constrain`` on
    DTensors."""
    worst = {"logits": 0.0, "cache": 0.0}
    for name, runs in RUNS.items():
        cfg = case_cfg(name)
        model = Model(cfg)
        shapes = model.param_shapes()
        for shape, batch in runs:
            if name in PUBLISHED:
                over, whole = PUBLISHED[name]
                want = _cut_dims(replace(get_arch(CASES[name][0]), **over),
                                 shape, batch)
                got = _cut_dims(cfg, shape, batch)
                for key in set(want) | set(got):
                    if key not in got and key[-1] in whole:
                        continue
                    assert got.get(key) == want.get(key), \
                        (name, shape, batch, key, got.get(key),
                         want.get(key))
            pre = f"{name}/{run_name(shape, batch)}/"
            mesh = MeshShape(("data", "model"), shape)
            pspecs = param_specs(shapes, cfg, mesh)
            cshapes = model.init_cache(
                {"embed": shapes["embed"], "layers": []}, batch, MAX_LEN)
            cspecs = cache_specs(cshapes, cfg, mesh, batch)
            split = batch % shape[0] == 0
            rows = {}
            one = {k[len(pre):]: v for k, v in spawned[0].items()
                   if k.startswith(pre + "one/")}
            for rank, fields in enumerate(spawned):
                f = {k[len(pre):]: v for k, v in fields.items()
                     if k.startswith(pre)}
                f.update(one)
                where = (name, shape, batch, rank)
                for k in ("prefill", "prefill_step", "logits"):
                    err = _rel_max(f[f"mesh/{k}"], f[f"one/{k}"])
                    worst["logits"] = max(worst["logits"], err)
                    assert err <= 1e-5, where + (k, err)
                assert np.array_equal(f["mesh/tokens"], f["one/tokens"]), \
                    where
                for k in ("cache0", "cache"):
                    err = _rel(f[f"mesh/{k}_kv"], f[f"one/{k}_kv"])
                    worst["cache"] = max(worst["cache"], err)
                    assert err <= 1e-6, where + (k, err)
                    assert np.array_equal(f[f"mesh/{k}_pos"],
                                          f[f"one/{k}_pos"]), where
                assert bool(f["drawn_equal"]), where
                coord = _coord(shape, rank)
                assert int(f["stored"]) == _stored(pspecs, shapes, mesh,
                                                   coord), where
                assert int(f["cache_stored"]) == _stored(
                    cspecs, cshapes, mesh, coord), where
                if cfg.n_experts == 0:
                    # the batch split over data divides the compute by
                    # every rank; at batch 1 over data, whole weights
                    # compute whole on each data rank, so only model's
                    # share is held
                    share = shape[1] * (shape[0] if split else 1)
                    assert f["mesh/flops"] <= 1.1 * f["one/flops"] / share, \
                        where + (f["mesh/flops"], f["one/flops"])
                if cfg.n_experts and shape[1] > 1:
                    own = _own_experts(cfg, shape, rank)
                    assert set(f["mesh/experts"][:, 1]) <= own, where
                    if split or coord["data"] == 0:
                        for call, e, n in f["mesh/experts"]:
                            key = (call, e)
                            rows[key] = rows.get(key, 0) + n
            if cfg.n_experts and shape[1] > 1:
                want = {(c, e): n for c, e, n in
                        spawned[0][pre + "one/experts"]}
                assert rows == want, (name, shape, batch)
    print(f"worst: logits {worst['logits']:.2e} of max |logit|, caches "
          f"{worst['cache']:.2e}")
    raises = list(spawned[0]["raises"])
    for what in ("w_in cut over 'model' on dim 0",
                 "2 heads do not split over 4 ranks",
                 "cross cache's k cut over 'model' on dim 3"):
        msg = raises.pop(0)
        assert what in msg, msg
    assert "not whole tensors" in raises.pop(0)
    for rank, fields in enumerate(spawned):
        assert list(fields["constrain/placements"]) == ["S(0)", "S(1)"]
        c = _coord((2, 2), rank)
        whole = np.arange(48, dtype=np.float32).reshape(8, 6)
        assert np.array_equal(
            fields["constrain/local"],
            whole[4 * c["data"]:4 * c["data"] + 4,
                  3 * c["model"]:3 * c["model"] + 3])
        assert list(fields["constrain/odd"]) == ["R", "R"]
        assert fields["constrain/same"].all()


# ---------------------------------------------------------------------------
# the reference's mesh steps, and its constrain

_REFERENCE = textwrap.dedent("""
    import os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    from dataclasses import replace
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import AxisType
    from repro.configs import get_arch, reduced
    from repro.models.model import Model
    from repro.serve.decode import make_prefill_step, make_serve_step
    from repro.sharding import constrain as jc

    with open(sys.argv[1], "rb") as f:
        spec = pickle.load(f)

    def mesh_of(shape, names):
        n = int(np.prod(shape))
        return jax.make_mesh(shape, names, devices=jax.devices()[:n],
                             axis_types=(AxisType.Auto,) * len(shape))

    out = {"runs": {}, "constrain": []}
    for key, run in spec["runs"].items():
        cfg = replace(reduced(get_arch(run["arch"])), **run["over"])
        model = Model(cfg)
        mesh = mesh_of(run["shape"], ("data", "model"))
        b = run["tokens"].shape[0]
        step, _ = make_serve_step(model, mesh, batch=b,
                                  max_len=spec["max_len"],
                                  cache_dtype=jnp.float32)
        pre = make_prefill_step(model, mesh, batch=b)
        params, cache = run["params"], run["cache"]
        tok = run["tokens"][:, -1].astype(np.int32)
        logits, toks = [], []
        with jax.set_mesh(mesh):
            for i in range(spec["steps"]):
                lg, cache = step(params, cache, tok,
                                 np.int32(spec["prompt"] + i))
                cache = jax.tree.map(np.asarray, cache)
                lg = np.asarray(lg)
                tok = lg.argmax(-1).astype(np.int32)
                logits.append(lg)
                toks.append(tok)
            pl = np.asarray(pre(params, run["inputs"]))
        out["runs"][key] = dict(logits=np.stack(logits),
                                tokens=np.stack(toks), prefill_step=pl)
    seen = []
    real = jax.lax.with_sharding_constraint

    def spy(x, s):
        seen.append(tuple(s))
        return real(x, s)
    jax.lax.with_sharding_constraint = spy
    for shape, names, xshape, dims in spec["constrain"]:
        seen.clear()
        with jax.set_mesh(mesh_of(shape, names)):
            jax.eval_shape(lambda x: jc.constrain(x, dims),
                           jax.ShapeDtypeStruct(xshape, jnp.float32))
        out["constrain"].append(seen[0] if seen else None)
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
""")

# (mesh shape, axis names, tensor shape, dims): the reference's sites'
# hints (vocab-parallel logits, the batch over the data axes, the MoE
# dispatch, the sequence-parallel residual) and its rules' edges (an
# absent or size-1 axis, a dim that does not divide or is smaller than
# the axis, a negative dim, several axes on one dim)
CONSTRAIN_TABLE = [
    ((4, 1), ("data", "model"), (4, 1, 512), {2: "model"}),
    ((1, 4), ("data", "model"), (4, 1, 512), {2: "model"}),
    ((2, 2), ("data", "model"), (4, 16, 512), {0: ("pod", "data"),
                                               2: "model"}),
    ((2, 2), ("data", "model"), (2, 16, 256), {0: ("pod", "data"),
                                               1: "model"}),
    ((2, 2), ("data", "model"), (3, 16, 256), {0: ("pod", "data"),
                                               1: "model"}),
    ((1, 4), ("data", "model"), (4, 2, 8, 256), {0: "model",
                                                 1: ("pod", "data")}),
    ((1, 4), ("data", "model"), (2, 4, 256), {0: "model"}),
    ((4, 1), ("data", "model"), (4, 16, 256), {-1: "model", -3: "data"}),
    ((2, 2, 2), ("pod", "data", "model"), (8, 4, 64),
     {0: ("pod", "data"), 1: "model"}),
    ((2, 2, 2), ("pod", "data", "model"), (2, 4, 64),
     {0: ("pod", "data"), 2: "model"}),
    ((2, 2, 2), ("pod", "data", "model"), (4, 6, 64), {1: "model",
                                                       2: ("data",)}),
    ((2, 4), ("data", "model"), (6, 3), {0: "data", 1: "model"}),
]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's ``STEPS`` greedy steps and prefill step (a VLM's
    with its image prefix) over the same meshes from the port's
    one-device prefill cache and weights
    (``convert``), and its ``constrain``'s picks over
    ``CONSTRAIN_TABLE``; one subprocess, each step compiled once, shared
    by xdist's workers as :func:`spawned` is."""
    from filelock import FileLock

    root = _shared_dir(tmp_path_factory, "mesh_serve_ref")
    out = root / "mesh_serve_reference.pkl"
    with FileLock(str(out) + ".lock"):
        if not out.exists():
            _run_reference(root, out)
    with open(out, "rb") as f:
        return pickle.load(f)


def _run_reference(work: Path, out: Path) -> None:
    runs = {}
    for name, shapes in REFERENCE_RUNS.items():
        cfg = case_cfg(name)
        model = Model(cfg)
        params = model.init(case_seed(name), device="cpu")
        for shape, batch in shapes:
            inputs = prefill_inputs(name, batch)
            _, cache = model.prefill(params, inputs, MAX_LEN)
            inputs = {k: v.numpy() for k, v in inputs.items()}
            inputs["tokens"] = inputs["tokens"].astype(np.int32)
            runs[f"{name}/{run_name(shape, batch)}"] = dict(
                arch=CASES[name][0], over=CASES[name][1], shape=shape,
                tokens=inputs["tokens"], inputs=inputs,
                params=convert.model_params_to_numpy(params, cfg),
                cache=convert.model_cache_to_numpy(cache, cfg))
    spec = dict(runs=runs, max_len=MAX_LEN, steps=STEPS, prompt=PROMPT,
                constrain=CONSTRAIN_TABLE)
    with open(work / "mesh_serve_in.pkl", "wb") as f:
        pickle.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    part = work / "mesh_serve_reference.part"
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(work / "mesh_serve_in.pkl"),
         str(part)], env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    part.rename(out)


def test_mesh_serve_matches_reference(spawned, reference):
    """On every rank, the mesh's greedy steps and prefill step against the
    reference's over the same mesh: logits within 1e-4 of max |logit|,
    the tokens exact; and ``constrain_spec`` picks, for every row of
    ``CONSTRAIN_TABLE``, the ``PartitionSpec`` the reference's
    ``constrain`` applies under ``jax.set_mesh`` (``None`` where it
    applies none)."""
    worst = 0.0
    for key, want in reference["runs"].items():
        for rank, fields in enumerate(spawned):
            for k in ("logits", "prefill_step"):
                err = _rel_max(fields[f"{key}/mesh/{k}"], want[k])
                worst = max(worst, err)
                assert err <= 1e-4, (key, rank, k, err)
            assert np.array_equal(fields[f"{key}/mesh/tokens"],
                                  want["tokens"]), (key, rank)
    print(f"worst against the reference: {worst:.2e} of max |logit|")
    assert len(reference["runs"]) == sum(map(len, REFERENCE_RUNS.values()))
    for row, want in zip(CONSTRAIN_TABLE, reference["constrain"]):
        shape, names, xshape, dims = row
        got = constrain_spec(xshape, dims, MeshShape(names, shape))
        assert (None if got is None else tuple(got)) == want, row


def test_serve_launcher_over_the_debug_mesh(spawned):
    """``launch.serve --debug-mesh`` over the 4 ranks (the (2, 2) mesh,
    each slot's batch of 1 with its cache's sequence over ``data``) gives
    every request the tokens of the (1, 1) mesh's run and of the plain
    launcher's, on every rank."""
    one = spawned[0]["launch/one"]
    assert one.shape == (3, 5)
    assert np.array_equal(one, spawned[0]["launch/plain"])
    for fields in spawned:
        assert np.array_equal(fields["launch/mesh"], one)
