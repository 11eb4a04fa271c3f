"""The spawned gloo ranks of ``tests/test_torch_mesh_serve.py``: the serve
steps over a ``DeviceMesh`` against the same steps on one device, on
every rank. Imports neither ``jax`` nor anything of ``repro``. Not a test
module (leading underscore).

As rank RANK of WORLD gloo ranks (``STORE`` a file the ranks rendezvous
on; rank r writes ``OUT_r.npz``)::

    python tests/_torch_mesh_serve_worker.py RANK WORLD STORE OUT

For every case of ``CASES`` and each (mesh, batch) of its ``RUNS``,
fields ``<case>/<run>/<field>`` (:func:`run_fields`): a prompt of
``PROMPT`` tokens a row prefilled by ``Model.prefill`` and ``STEPS``
greedy steps of ``make_serve_step``, over the mesh (weights stored by
``param_specs`` as they are drawn) and on one device (``mesh=None``, on
rank 0); ``make_prefill_step`` (with a VLM's image prefix) both ways;
each rank's stored elements; one decode step's matmul FLOPs both ways
and the MoE experts' rows it computed.
Then ``launch.serve --debug-mesh`` over the 4 ranks (the (2, 2) mesh) and,
on rank 0 after the group ends, alone (the (1, 1) mesh).
"""
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

# name -> (arch, fields replaced after ``reduced``): gemma2 ("L", "A",
# both softcaps), mixtral stored over the data axes too (``fsdp``) and its
# MoE, llama4's chunked "C" layers and top-1 MoE, a dense config whose
# 2 KV heads do not divide a model axis of 4 (wk / wv cut on D,
# row-parallel), and paligemma's decoder (one KV head, row-parallel too)
# with its image prefix through ``make_prefill_step``. ``reduced``'s
# d_model 256 and 4 heads keep every sharded leaf above the rules' 64 KiB
CASES = {
    "gemma2": ("gemma2-2b", {}),
    "mixtral_fsdp": ("mixtral-8x7b", {"fsdp": True}),
    "llama4": ("llama4-maverick-400b-a17b", {}),
    "dense_kv2": ("mistral-large-123b", {"n_kv_heads": 2}),
    "paligemma": ("paligemma-3b", {}),
}
# (data, model) mesh and batch: (4, 1) at batch 1 is the reference's
# long_500k (the cache's sequence over data); (2, 2) at batch 2 splits the
# batch over data and the heads over model; (1, 4) is tensor parallelism
# alone; (2, 2) at batch 1 (the sequence over data, the heads over model)
# and (4, 1) at batch 4 (the batch over data alone; mixtral's routing over
# four ranks' tokens) the other mixes; paligemma at batch 1 (its one KV
# head cuts a cache split over the batch on head_dim, which the mesh
# steps refuse: ``raises_fields``)
MAIN_RUNS = (((4, 1), 1), ((2, 2), 2), ((1, 4), 4))
VLM_RUNS = (((1, 4), 1), ((4, 1), 1))
RUNS = {
    "gemma2": MAIN_RUNS + (((2, 2), 1), ((4, 1), 4)),
    "mixtral_fsdp": MAIN_RUNS + (((4, 1), 4),),
    "llama4": MAIN_RUNS,
    "dense_kv2": (((1, 4), 4),),
    "paligemma": VLM_RUNS,
}
# the runs the reference's mesh steps are held to as well
REFERENCE_RUNS = {**{c: MAIN_RUNS for c in ("gemma2", "mixtral_fsdp",
                                            "llama4")},
                  "paligemma": VLM_RUNS}
# a prompt past the reduced window and chunk (64), a cache of 76 slots
# (divides 4 data ranks); the greedy steps wrap the "L" ring
PROMPT, STEPS = 72, 4
MAX_LEN = PROMPT + STEPS
LAUNCH = ["--smoke", "--device", "cpu", "--requests", "3", "--batch", "2",
          "--prompt-len", "12", "--gen", "4"]


def run_name(shape, batch) -> str:
    return f"{shape[0]}x{shape[1]}_b{batch}"


def case_cfg(name: str):
    from repro_torch.configs import get_arch, reduced

    arch, over = CASES[name]
    return replace(reduced(get_arch(arch)), **over)


def case_seed(name: str) -> int:
    return list(CASES).index(name)


def prompt(name: str, batch: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(100 + case_seed(name) * 10 + batch)
    return torch.randint(0, case_cfg(name).vocab_size, (batch, PROMPT),
                         generator=gen)


def prefill_inputs(name: str, batch: int) -> dict:
    """``make_prefill_step``'s inputs: the prompt and, for a VLM, its
    image prefix (``vis_tokens`` patch embeddings a row)."""
    cfg = case_cfg(name)
    out = {"tokens": prompt(name, batch)}
    if cfg.vis_tokens:
        gen = torch.Generator().manual_seed(200 + case_seed(name) * 10 + batch)
        out["patches"] = torch.randn((batch, cfg.vis_tokens, cfg.d_model),
                                     generator=gen)
    return out


def greedy(model, params, tokens, step, prefill) -> dict:
    """Prefill, then ``STEPS`` greedy steps from the prompt's last token
    at index ``PROMPT``: the logits, tokens and caches whole."""
    from repro_torch.sharding import full_tree

    logits, cache = prefill(params, {"tokens": tokens}, MAX_LEN)
    out = {"prefill": whole(logits).numpy(),
           **flat_cache(full_tree(cache), "cache0")}
    tok = tokens[:, -1]
    steps, toks = [], []
    for i in range(STEPS):
        logits, cache = step(params, cache, tok, PROMPT + i)
        lg = whole(logits)
        steps.append(lg.numpy())
        tok = torch.argmax(lg, dim=-1)
        toks.append(tok.numpy())
    out.update(logits=np.stack(steps), tokens=np.stack(toks),
               **flat_cache(full_tree(cache), "cache"))
    return out


def whole(x: torch.Tensor) -> torch.Tensor:
    return (x.full_tensor() if hasattr(x, "full_tensor") else x).detach()


def flat_cache(cache, tag: str) -> dict:
    """``<tag>_kv``: every key and value of a cache flattened and
    concatenated (float64); ``<tag>_pos``: every position."""
    from repro_torch.tree import tree_leaves

    leaves = tree_leaves(cache)
    return {f"{tag}_{k}": torch.cat([x.detach().reshape(-1).double()
                                     for x in leaves
                                     if x.is_floating_point() == fl]).numpy()
            for k, fl in (("kv", True), ("pos", False))}


def local_numel(tree) -> int:
    from repro_torch.tree import tree_leaves

    return sum((x.to_local() if hasattr(x, "to_local") else x).numel()
               for x in tree_leaves(tree))


def drawn_equal(params, whole_params, mesh, model) -> bool:
    """Every local shard of the weights drawn over the mesh is the bits
    of ``shard_tree(whole_params)``'s."""
    from repro_torch.sharding import param_specs, shard_tree
    from repro_torch.tree import tree_leaves

    specs = param_specs(model.param_shapes(), model.cfg, mesh)
    cut = shard_tree(whole_params, specs, mesh)
    return all(torch.equal(a.to_local(), b.to_local())
               for a, b in zip(tree_leaves(params), tree_leaves(cut)))


class ExpertSpy:
    """Records the rows each MoE expert computes, a dict a MoE layer per
    forward: {global expert: rows}."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.calls = moe, []
        self.real_fwd, self.real_ffn = moe.moe_forward, moe._expert_ffn

    def __enter__(self):
        spy = self

        def fwd(params, *a, **k):
            spy.calls.append({})
            spy.lo = 0
            e_loc = params["w_up"].shape[0]
            tp = k.get("tp")
            if tp is not None and e_loc < a[1].n_experts:
                spy.lo = tp.model.rank * e_loc
            return spy.real_fwd(params, *a, **k)

        def ffn(params, e, x, cfg):
            d = spy.calls[-1]
            d[spy.lo + e] = d.get(spy.lo + e, 0) + x.shape[0]
            return spy.real_ffn(params, e, x, cfg)
        self.moe.moe_forward, self.moe._expert_ffn = fwd, ffn
        return self

    def __exit__(self, *exc):
        self.moe.moe_forward, self.moe._expert_ffn = (self.real_fwd,
                                                      self.real_ffn)

    def table(self) -> np.ndarray:
        """(call, expert, rows) rows."""
        rows = [(i, e, n) for i, d in enumerate(self.calls)
                for e, n in sorted(d.items())]
        return np.array(rows, np.int64).reshape(-1, 3)


def step_costs(model, params, cache, tokens, step) -> dict:
    """One decode step's matmul FLOPs, its experts' rows and (over a
    mesh) its collectives, from a copy of the cache's state."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import parallel

    parallel.reset_collective_counts()
    with ExpertSpy() as spy, FlopCounterMode(display=False) as fc:
        step(params, cache, tokens[:, -1], PROMPT)
    counts = parallel.collective_counts()
    return {"flops": np.asarray(fc.get_total_flops()),
            "experts": spy.table(),
            "collectives": np.array([counts["all_reduce"],
                                     counts["all_gather"]])}


def run_fields(name: str, shape, batch: int, mesh) -> dict:
    from repro_torch.models.model import Model
    from repro_torch.serve import make_prefill_step, make_serve_step

    model = Model(case_cfg(name))
    seed = case_seed(name)
    ref = model.init(seed, device="cpu")
    params = model.init(seed, device="cpu", mesh=mesh)
    tokens = prompt(name, batch)
    out = {"drawn_equal": np.asarray(drawn_equal(params, ref, mesh, model)),
           "stored": np.asarray(local_numel(params))}
    step1, none = make_serve_step(model)
    assert none is None
    stepm, _ = make_serve_step(model, mesh, batch=batch, max_len=MAX_LEN)
    # the one-device steps are the same on every rank: rank 0 runs them
    runs = (("one", ref, step1, None),) if dist.get_rank() == 0 else ()
    for tag, p, step, m in runs + (("mesh", params, stepm, mesh),):
        for k, v in greedy(model, p, tokens, step, model.prefill).items():
            out[f"{tag}/{k}"] = v
        _, cache = model.prefill(p, {"tokens": tokens}, MAX_LEN)
        if tag == "mesh":
            out["cache_stored"] = np.asarray(local_numel(cache))
        for k, v in step_costs(model, p, cache, tokens, step).items():
            out[f"{tag}/{k}"] = v
        pre = make_prefill_step(model, m, batch=batch)
        out[f"{tag}/prefill_step"] = whole(
            pre(p, prefill_inputs(name, batch))).numpy()
    return out


def raises_fields(meshes) -> dict:
    """What the mesh steps refuse, by message: the families not ported
    yet, a cache cut over ``model`` on head_dim (paligemma's one KV head
    on the (2, 2) mesh at batch 2), and whole (not DTensor) params."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.model import Model
    from repro_torch.serve import make_prefill_step, make_serve_step

    out = []
    for arch in ("whisper-small", "recurrentgemma-2b", "rwkv6-1.6b"):
        try:
            make_serve_step(Model(reduced(get_arch(arch))), meshes[(2, 2)],
                            batch=2, max_len=MAX_LEN)
            out.append("no error")
        except NotImplementedError as e:
            out.append(str(e))
    model = Model(reduced(get_arch("paligemma-3b")))
    params = model.init(0, device="cpu", mesh=meshes[(2, 2)])
    try:
        model.prefill(params, {"tokens": torch.zeros((2, 8), dtype=torch.long)},
                      MAX_LEN)
        out.append("no error")
    except NotImplementedError as e:
        out.append(str(e))
    pre = make_prefill_step(model, meshes[(1, 4)], batch=1)
    try:
        pre(model.init(0, device="cpu"),
            {"tokens": torch.zeros((1, 8), dtype=torch.long)})
        out.append("no error")
    except TypeError as e:
        out.append(str(e))
    return {"raises": np.array(out)}


def constrain_fields(mesh) -> dict:
    """``constrain`` on the (2, 2) mesh: a replicated DTensor under
    ``use_mesh`` redistributed to the reference's placements (its local
    shard), one whose dims do not divide left as it is, a plain tensor
    and a DTensor with no ambient mesh returned as they are."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.sharding import constrain, use_mesh

    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    rep = DTensor.from_local(x, mesh, [Replicate(), Replicate()],
                             run_check=False)
    with use_mesh(mesh):
        cut = constrain(rep, {0: "data", 1: "model"})
        odd = constrain(rep[:, :5].redistribute(mesh, [Replicate()] * 2),
                        {1: "model"})
        plain = constrain(x, {0: "data"})
    return {"constrain/placements": np.array([str(p)
                                              for p in cut.placements]),
            "constrain/local": cut.to_local().numpy(),
            "constrain/odd": np.array([str(p) for p in odd.placements]),
            "constrain/same": np.array([plain is x,
                                        constrain(rep, {0: "data"}) is rep])}


def main(argv) -> int:
    rank, world, store, out = int(argv[1]), int(argv[2]), argv[3], argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import live_mesh
    from repro_torch.sharding import MeshShape

    fields = {}
    try:
        meshes = {s: live_mesh(MeshShape(("data", "model"), s), "cpu")
                  for s in ((4, 1), (2, 2), (1, 4))}
        for name, runs in RUNS.items():
            for shape, batch in runs:
                for k, v in run_fields(name, shape, batch,
                                       meshes[shape]).items():
                    fields[f"{name}/{run_name(shape, batch)}/{k}"] = v
        fields.update(raises_fields(meshes))
        fields.update(constrain_fields(meshes[(2, 2)]))
        res = serve.main(LAUNCH + ["--debug-mesh"])
        fields["launch/mesh"] = launch_tokens(res)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        fields["launch/one"] = launch_tokens(serve.main(LAUNCH +
                                                        ["--debug-mesh"]))
        fields["launch/plain"] = launch_tokens(serve.main(LAUNCH))
    np.savez(f"{out}_{rank}.npz", **fields)
    return 0


def launch_tokens(res) -> np.ndarray:
    """(request id, its generated tokens...) rows in request order."""
    return np.array(sorted([r.rid] + r.generated for r in res.requests))


if __name__ == "__main__":
    here = Path(__file__).resolve().parent
    sys.path[:0] = [str(here), str(here.parent / "src")]
    sys.exit(main(sys.argv))
