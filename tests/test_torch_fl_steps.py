"""The port's federated LLM train steps against the JAX reference on
identical inputs: ``select_clients`` on exact ties, ``MeshTopology``, the
two-phase and fused Cost-TrustFL steps at world size 1 against the
reference's step on a (4, 1) mesh of host devices (every family: gemma2,
recurrentgemma, mixtral's MoE in the fused step, rwkv6, whisper with
frames, paligemma with patches in both strategies), spawned gloo ranks
against world size 1, MoE routing over the ranks against the reference's
routing of all rows, the launcher on every family, and the example.

The reference's steps run once a module, in one subprocess with 4 host
devices (as ``tests/test_fl_steps.py`` runs them), on the port's seeded
weights carried over through ``convert``; every input goes in as numpy,
so the reference's jit compiles each step once. Its Ω (the fused
step's sketch, drawn from ``jax.random``) comes back and is replayed.

Tolerances, fp32 on the CPU, with their reasons:
* the selected mask exact (selection reads only the reputation, which
  the first step gets exact and the second within 1e-5, away from ties);
* ``round_cost_units`` within 1e-6 relative (one fp32 sum of the same
  costs);
* the loss, φ, trust, β and the reputation within 1e-5 relative (norm
  of the difference over the norm of the reference; the port sums the
  clients' statistics in another order);
* every parameter leaf within 1e-4 relative after two steps, and the
  two steps' update (params after − before, over the whole tree) too.
"""
import ast
import dataclasses
import importlib.util
import os
import pickle
import subprocess
import sys
import textwrap
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_fl_step_worker import (CASES, FL, LOSS_CHUNK, LR, METRICS,
                                   N_CLIENTS, SPAWNED, flat, inputs,
                                   port_cfg, run_steps, tensors)
from _torch_threads import one_torch_thread  # noqa: F401 (autouse)
from repro_torch import convert
from repro_torch.configs.base import FLConfig
from repro_torch.core.selection import select_clients
from repro_torch.train import ClientMesh, MeshTopology

ROOT = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).resolve().parent / "_torch_fl_step_worker.py"


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


# ---------------------------------------------------------------------------
# (0) exact ties in selection

def _tied(n, k, seed=None):
    """A uniform reputation and ``MeshTopology.unit_costs``-shaped costs
    (cloud 0 cheaper, equal within a cloud); with ``seed``, reputations
    drawn from 3 values, so ties span clouds too."""
    costs = MeshTopology.from_mesh(ClientMesh(n), k).unit_costs(0.01, 0.09)
    rep = np.full(n, 1.0 / n, np.float32)
    if seed is not None:
        rep = np.random.default_rng(seed).choice(
            np.float32([0.1, 0.2, 0.3]), n)
    return rep, costs.astype(np.float32)


@pytest.mark.parametrize("n, k, m, quota, seed", [
    (4, 2, 3, 0, None), (8, 4, 5, 0, None), (16, 4, 6, 0, None),
    (8, 4, 5, 2, None), (12, 3, 7, 2, None), (16, 4, 6, 0, 1),
    (12, 3, 8, 2, 2), (30, 3, 10, 0, 3)])
def test_select_clients_breaks_exact_ties_as_lax_top_k(n, k, m, quota, seed):
    """No noise, exactly tied ratios: the port's mask equals
    ``select_clients_jax``'s (the lower index first among ties), in the
    plain top-m, in each cloud's quota and in the fill."""
    import jax.numpy as jnp
    from repro.core.selection import select_clients_jax

    rep, costs = _tied(n, k, seed)
    cloud_of = np.arange(n) // (n // k) if quota else None
    want = np.asarray(select_clients_jax(
        jnp.asarray(rep), jnp.asarray(costs), m, 0.3, per_cloud_min=quota,
        cloud_of=cloud_of))
    got = select_clients(torch.tensor(rep), torch.tensor(costs), m, 0.3,
                         per_cloud_min=quota, cloud_of=cloud_of).numpy()
    assert np.array_equal(got, want), (np.nonzero(got)[0],
                                       np.nonzero(want)[0])


# ---------------------------------------------------------------------------
# (a) the topology

@pytest.mark.parametrize("shape, names, n_clouds", [
    ((4, 1), ("data", "model"), 2), ((4, 2), ("data", "model"), None),
    ((8,), ("data",), 3), ((6, 1), ("data", "model"), 4),
    ((16, 1), ("data", "model"), None), ((1, 2), ("data", "model"), None),
    ((12,), ("data",), 5), ((9, 2), ("data", "model"), 6)])
def test_mesh_topology_matches_reference(shape, names, n_clouds):
    """Every field, ``cloud_of`` and ``unit_costs`` (both aggregator
    clouds) against the reference's, on a single-pod ``AbstractMesh``
    (no devices)."""
    from jax.sharding import AbstractMesh
    from repro.train.steps import MeshTopology as JMeshTopology

    want = JMeshTopology.from_mesh(AbstractMesh(shape, names), n_clouds)
    got = MeshTopology.from_mesh(ClientMesh(shape[0]), n_clouds)
    for field in ("daxes", "n_clients", "n_clouds", "clients_per_cloud",
                  "pod_aligned"):
        assert getattr(got, field) == getattr(want, field), field
    assert np.array_equal(got.cloud_of(), want.cloud_of())
    for agg in (0, got.n_clouds - 1):
        assert np.array_equal(got.unit_costs(0.01, 0.09, agg),
                              want.unit_costs(0.01, 0.09, agg))


# ---------------------------------------------------------------------------
# (b) world size 1 against the reference's step on the mesh (4, 1)

_REFERENCE = textwrap.dedent("""
    import math, os, pickle, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    from dataclasses import replace
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_arch, reduced
    from repro.configs.base import FLConfig
    from repro.models.model import Model
    from repro.optim import sgd
    from repro.train import make_fl_train_step

    with open(sys.argv[1], "rb") as f:
        spec = pickle.load(f)
    mesh = jax.make_mesh((4, 1), ("data", "model"))
    tonp = lambda t: jax.tree.map(np.asarray, t)
    fl = FLConfig(**spec["fl"])
    out = {}
    for name, case in spec["cases"].items():
        arch, d_model, layers, num_layers, strategy, over = case["case"]
        cfg = reduced(get_arch(arch), d_model=d_model, layers=layers)
        if num_layers is not None:
            cfg = replace(cfg, num_layers=num_layers)
        cfg = replace(cfg, **over)
        opt = sgd(spec["lr"])
        step, topo = make_fl_train_step(Model(cfg), mesh, fl, opt,
                                        strategy=strategy,
                                        loss_chunk=spec["loss_chunk"])
        params = case["params"]
        opt_state = tonp(opt[0](params))
        rep = np.full((topo.n_clients,), 1.0 / topo.n_clients, np.float32)
        recs = []
        for t, (batch, ref) in enumerate(case["steps"]):
            extra, omega = (), None
            if strategy == "fused":
                key = jax.random.PRNGKey(t + 1)
                omega = np.asarray((2.0 * jax.random.bernoulli(
                    key, 0.5, (cfg.vocab_size, fl.sketch_dim)).astype(
                        jnp.float32) - 1.0) / math.sqrt(fl.sketch_dim))
                extra = (key,)
            params, opt_state, rep, met = tonp(step(params, opt_state, rep,
                                                    batch, ref, *extra))
            recs.append(dict(met, rep=rep, omega=omega))
        out[name] = dict(steps=recs, params=params)
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
""")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every case's ``STEPS`` chained reference steps, from the port's
    seeded weights and the same numpy batches: {case: {"steps": [metrics,
    "rep", "omega"], "params": the final reference tree}}. The modules
    and pytest-xdist workers of one session share one run (the first to
    take the lock computes it into the session's temporary root; the
    others wait and read it), since the cases' tests may land on several
    workers and ``test_torch_mesh_steps`` holds its mesh steps to it."""
    from filelock import FileLock

    shared = os.environ.get("PYTEST_XDIST_WORKER") is not None
    work = tmp_path_factory.getbasetemp()
    work = work.parent if shared else work
    out = work / "fl_steps_reference.pkl"
    with FileLock(str(out) + ".lock"):
        if not out.exists():
            _run_reference(work, out)
    with open(out, "rb") as f:
        return pickle.load(f)


def _run_reference(work: Path, out: Path) -> None:
    cases = {}
    for name, case in CASES.items():
        params, steps = inputs(name)
        cases[name] = dict(case=case, steps=steps,
                           params=convert.model_params_to_numpy(
                               params, port_cfg(name)))
    spec = dict(cases=cases, fl=FL, lr=LR, loss_chunk=LOSS_CHUNK)
    with open(work / "fl_steps_in.pkl", "wb") as f:
        pickle.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    part = work / "fl_steps_reference.part"
    proc = subprocess.run(
        [sys.executable, "-c", _REFERENCE, str(work / "fl_steps_in.pkl"),
         str(part)], env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    part.rename(out)


def _drifts(got: dict, want: dict) -> dict:
    """Relative drifts of a port step's record from the reference's. The
    two-phase reference's ``beta`` is cloud 0's β̂ (its replicated output
    reads the first device); the port's holds every cloud's."""
    g_beta = got["beta"]
    if np.ndim(want["beta"]) == 0:
        g_beta = g_beta[0]
    out = {k: _rel(got[k], want[k]) for k in ("loss", "phi", "trust", "rep")}
    out["beta"] = _rel(g_beta, want["beta"])
    out["round_cost_units"] = _rel(got["round_cost_units"],
                                   want["round_cost_units"])
    return out


def hold_to_reference(name: str, recs: list, params, ref: dict) -> None:
    """A port run of the case's ``STEPS`` chained steps (a record a step
    {metric: array, "rep": array}, the final params) against the
    reference's: the mask exact, the cost units within 1e-6, the loss,
    φ, trust, β and reputation within 1e-5 relative, every parameter
    leaf and the update within 1e-4."""
    import jax

    for t, (got, want) in enumerate(zip(recs, ref["steps"])):
        assert set(METRICS) <= set(want)
        assert np.array_equal(got["selected"], want["selected"]), t
        drift = _drifts(got, want)
        print(f"{name} step {t}: {drift}")
        assert drift.pop("round_cost_units") <= 1e-6, t
        assert max(drift.values()) <= 1e-5, (t, drift)
    worst = 0.0
    got_tree = convert.model_params_to_numpy(params, port_cfg(name))
    want_leaves = jax.tree_util.tree_flatten_with_path(ref["params"])[0]
    got_leaves = dict(jax.tree_util.tree_flatten_with_path(got_tree)[0])
    for path, w in want_leaves:
        err = _rel(got_leaves[path], w)
        assert err <= 1e-4, (jax.tree_util.keystr(path), err)
        worst = max(worst, err)
    # the update itself, over the whole tree: Δ = params after − before
    before = convert.model_params_to_numpy(inputs(name)[0], port_cfg(name))
    delta = [(got_leaves[path] - b, w - b) for (path, w), b in
             zip(want_leaves, jax.tree_util.tree_leaves(before))]
    update = _rel(np.concatenate([d[0].ravel() for d in delta]),
                  np.concatenate([d[1].ravel() for d in delta]))
    print(f"{name}: worst parameter leaf {worst:.2e}, the update "
          f"{update:.2e} relative")
    assert update <= 1e-4


@pytest.mark.parametrize("name", sorted(CASES))
def test_world_size_one_matches_reference(name, reference, monkeypatch):
    """``STEPS`` chained SGD steps at world size 1 (one gloo rank, started
    and ended by the step) against the reference's on the mesh (4, 1):
    the mask exact, the cost units within 1e-6, the loss, φ, trust, β and
    reputation within 1e-5 relative, every parameter leaf and the update
    within 1e-4.
    The second step starts from the first's reputation (not uniform).
    The two-phase step evaluates N + K gradients in pass A and one more
    per client with a weight (or cloud falling back on its reference) in
    pass B: the model's loss is counted."""
    from repro_torch.models import transformer as tfm

    ref = reference[name]
    omegas = [s["omega"] for s in ref["steps"]]
    calls = []
    loss_fn = tfm.loss_fn
    monkeypatch.setattr(tfm, "loss_fn", lambda *a, **k: (calls.append(1),
                                                         loss_fn(*a, **k))[1])
    recs, params = run_steps(name, omegas=omegas)
    assert not dist.is_initialized()
    hold_to_reference(name, recs, params, ref)
    if CASES[name][4] == "two_phase":
        k = FL["n_clouds"]
        want_calls = 0
        for rec in recs:
            ts_cloud = rec["trust"].reshape(k, -1).sum(1)
            beta = rec["beta"]
            weighted = sum(bool(ts > 0 and beta[i // (N_CLIENTS // k)] > 0)
                           for i, ts in enumerate(rec["trust"]))
            fallback = sum(bool(ts_cloud[c] <= 1e-12 and beta[c] > 0)
                           for c in range(k))
            want_calls += N_CLIENTS + k + weighted + fallback
        assert len(calls) == want_calls


# ---------------------------------------------------------------------------
# (c) spawned gloo ranks against world size 1

def _spawn(tmp_path, world: int, *mode: str):
    """``world`` gloo ranks of ``_torch_fl_step_worker.py`` (a time limit
    each, past which the test fails): each rank's npz fields."""
    out = tmp_path / "rank"
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), str(world),
         str(tmp_path / "store"), str(out), *mode],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=180)[0].decode()[-2000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), logs
    return [dict(np.load(f"{out}_{r}.npz")) for r in range(world)]


@pytest.mark.parametrize("world", [2, 4])
def test_spawned_ranks_match_world_size_one(world, tmp_path):
    """``world`` gloo ranks, each a process (``_torch_fl_step_worker.py``),
    run ``SPAWNED`` (gemma2's two-phase and fused steps, and mixtral's
    fused step, whose MoE layers drop tokens: Ω from its seed) on the
    mesh ``mesh_axes(2, 4, world)`` (2 x 1: a cloud a rank; 2 x 2: two
    ranks a cloud). Every rank's outputs equal rank 0's, and those hold
    to this process's world-size-1 run within 1e-5, the mask exact: the
    fused step routes MoE tokens over the global batch, whatever the
    ranks."""
    ranks = _spawn(tmp_path, world)
    for got in ranks[1:]:
        assert got.keys() == ranks[0].keys()
        for key, v in got.items():
            assert np.array_equal(v, ranks[0][key]), key
    for name in SPAWNED:
        recs, params = run_steps(name)
        for t, one in enumerate(recs):
            many = {k: ranks[0][f"{name}/{t}/{k}"] for k in one}
            assert np.array_equal(many["selected"], one["selected"])
            drift = {k: _rel(many[k], one[k]) for k in one}
            print(f"{world} ranks, {name} step {t}: {drift}")
            assert max(drift.values()) <= 1e-5, (name, t, drift)
        assert _rel(ranks[0][f"{name}/params"], flat(params)) <= 1e-5


def test_moe_routes_over_ranks_as_the_reference_over_all_rows(tmp_path):
    """``moe.route_over_ranks`` on two gloo ranks, each running one MoE
    layer on half of ``moe_inputs``' rows (mixtral's layout, capacity
    factor 0.5: the global capacity keeps 16 of 64 tokens an expert, one
    rank's own would keep 8 of 32), against the reference's
    ``moe_forward`` on all rows: the kept (expert, token) pairs equal the
    reference's routing; the rows' outputs, the ranks' aux shares summed
    and their gradients in the router summed within 1e-5 relative of the
    reference's output, aux loss and ``jax.grad`` of it."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_arch as jget_arch
    from repro.configs import reduced as jreduced
    from repro.models import moe as jmoe

    from _torch_fl_step_worker import moe_inputs
    from _torch_zoo import ref_kept

    cfg, params, x = moe_inputs()
    jcfg = replace(jreduced(jget_arch("mixtral-8x7b"), d_model=cfg.d_model),
                   capacity_factor=cfg.capacity_factor)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    ranks = _spawn(tmp_path, 2, "moe")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    out, aux = jmoe.moe_forward(jp, jnp.asarray(x), jcfg)
    g_router = jax.grad(lambda r: jmoe.moe_forward(
        dict(jp, router=r), jnp.asarray(x), jcfg)[1])(jp["router"])
    kept, routed = ref_kept(jp, jnp.asarray(x), jcfg)
    for rank in ranks:
        assert {tuple(p) for p in rank["kept"].tolist()} == kept
    assert routed - len(kept) > 0          # the global routing drops
    drift = dict(
        out=_rel(np.concatenate([r["out"] for r in ranks]), out),
        aux=_rel(sum(r["aux"] for r in ranks), aux),
        aux_grad=_rel(sum(r["aux_grad_router"] for r in ranks), g_router))
    print(f"route_over_ranks, 2 ranks: {drift}, dropped "
          f"{routed - len(kept)} of {routed}")
    assert max(drift.values()) <= 1e-5, drift


@pytest.mark.parametrize("strategy", ["two_phase", "fused"])
def test_step_refuses_a_batch_that_does_not_split(strategy):
    """7 rows over 4 clients: the step raises (the reference's shard_map
    refuses such a batch too) and ends the group its call started."""
    from repro_torch.models.model import Model
    from repro_torch.optim import sgd
    from repro_torch.train import make_fl_train_step

    name = "gemma2_" + strategy
    params, [(batch, ref)] = inputs(name)[0], inputs(name)[1][:1]
    opt = sgd(0.1)
    step, _ = make_fl_train_step(Model(port_cfg(name)), ClientMesh(4),
                                 FLConfig(**FL), opt, strategy=strategy)
    key = (1,) if strategy == "fused" else ()
    with step, pytest.raises(ValueError, match="does not split over 4"):
        step(params, opt[0](params), torch.full((4,), 0.25),
             tensors({k: v[:7] for k, v in batch.items()}), tensors(ref),
             *key)
    assert not dist.is_initialized()


def test_step_refuses_leaves_of_unequal_rows():
    """A VLM batch whose patches hold fewer rows than its tokens: the
    step raises before any forward and ends the group its call
    started."""
    from repro_torch.models.model import Model
    from repro_torch.optim import sgd
    from repro_torch.train import make_fl_train_step

    name = "paligemma_two_phase"
    params, [(batch, ref)] = inputs(name)[0], inputs(name)[1][:1]
    batch = dict(batch, patches=batch["patches"][:-1])
    opt = sgd(0.1)
    step, _ = make_fl_train_step(Model(port_cfg(name)), ClientMesh(4),
                                 FLConfig(**FL), opt)
    with step, pytest.raises(ValueError, match="differ in rows"):
        step(params, opt[0](params), torch.full((4,), 0.25),
             tensors(batch), tensors(ref))
    assert not dist.is_initialized()


def test_worker_imports_neither_jax_nor_reference():
    """The spawned ranks' code is the port's alone."""
    for path in (WORKER, ROOT / "examples" / "federated_llm_train_torch.py",
                 ROOT / "src" / "repro_torch" / "launch" / "train.py",
                 ROOT / "src" / "repro_torch" / "train" / "steps.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom)
                     else [])
            for mod in names:
                assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    (path.name, mod)


# ---------------------------------------------------------------------------
# (d) the launcher and the example

@pytest.mark.parametrize("arch", [
    "gemma2-2b", "mixtral-8x7b", "llama4-maverick-400b-a17b", "rwkv6-1.6b",
    "whisper-small", "paligemma-3b"])
def test_launcher_smoke_runs_on_the_cpu(arch, tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch ARCH --smoke --steps 1
    --device cpu`` on every family: the config's strategy (mixtral's and
    llama4's fused, the rest two-phase), 4 clients in 2 clouds, a
    one-rank gloo group it starts and ends; the loss finite, whisper's
    batches with frames and paligemma's with patches, which refuses a
    ``--seq`` that leaves no text after its image tokens. gemma2-2b
    (the default) runs 2 two-phase steps, then the fused strategy with a
    checkpoint, restored."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.configs import get_arch
    from repro_torch.launch import train

    if arch != "gemma2-2b":
        strategy = get_arch(arch).fl_strategy
        res = train.main(["--arch", arch, "--smoke", "--steps", "1",
                          "--device", "cpu"])
        out = capsys.readouterr().out
        assert f"clients=4 clouds=2 strategy={strategy}" in out
        assert out.count("loss=") == 1 and not dist.is_initialized()
        assert np.isfinite(float(res["metrics"]["loss"]))
        if arch == "paligemma-3b":
            with pytest.raises(ValueError, match="leaves no text after"):
                train.main(["--arch", arch, "--smoke", "--seq", "8",
                            "--device", "cpu"])
        return
    train.main(["--smoke", "--steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "clients=4 clouds=2 strategy=two_phase" in out
    assert out.count("loss=") == 2 and not dist.is_initialized()
    ckpt = tmp_path / "ckpt"
    res = train.main(["--smoke", "--steps", "1", "--device", "cpu",
                      "--strategy", "fused", "--seq", "32", "--batch", "4",
                      "--ckpt", str(ckpt)])
    assert "strategy=fused" in capsys.readouterr().out
    tree, meta = restore_checkpoint(str(ckpt), {"params": res["params"],
                                                "rep": res["rep"]})
    assert meta["step"] == 1 and meta["arch"] == "gemma2-2b"
    assert torch.equal(tree["rep"], res["rep"])
    assert torch.equal(tree["params"]["embed"], res["params"]["embed"])


def test_example_runs_on_the_cpu(capsys):
    """``examples/federated_llm_train_torch.py`` at a tiny size: 4
    cohorts in 2 clouds, 3 selected, cohort 3 flipping its tokens; the
    loss finite, the reputation summing to about 1, the verdict line."""
    spec = importlib.util.spec_from_file_location(
        "federated_llm_train_torch",
        ROOT / "examples" / "federated_llm_train_torch.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    res = example.main(["--steps", "3", "--seq", "16", "--d-model", "32",
                        "--layers", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "4 client cohorts in 2 clouds (select 3/round)" in out
    assert "reputation: attacker=" in out and not dist.is_initialized()
    assert np.isfinite(res["losses"]).all() and len(res["losses"]) == 3
    assert abs(float(res["rep"].sum()) - 1.0) < 0.5
