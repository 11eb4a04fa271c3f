"""The port-only side of ``tests/test_torch_sharded.py``: the small
configurations, the sharded engine's chained rounds on the CPU, and the
code of the spawned gloo ranks of its multi-rank test. Imports neither
``jax`` nor anything of ``repro``. Not a test module (leading underscore).

As a rank of a gloo group (``STORE`` a file the ranks rendezvous on;
rank r writes ``OUT_r.npz``)::

    python tests/_torch_shard_worker.py RANK WORLD STORE OUT

Every rank runs ``RUNS`` over the whole group (fields ``world/<run>/...``);
then the ranks of ``PAIR`` run them again over an explicit two-rank
subgroup (fields ``pair/<run>/...``), the engine's mesh 1 x 2 inside a
larger world.
"""
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

CPU = torch.device("cpu")

# tests/test_determinism.py's small topology (N = 12, 3 clouds)
SMALL = dict(n_clouds=3, clients_per_cloud=4, clients_per_round=6,
             local_epochs=1, local_batch=8, ref_samples=16)
SMALL_DATA = dict(n_samples=600, samples_per_client=16)
HEADLINE = dict(attack="label_flip", malicious_frac=0.3, compressor="topk",
                compress_ratio=0.1, link_policy="cross_only")
DEFENSE = dict(attack="alie_norm", malicious_frac=0.3,
               trust_features="multi", compressor="qsgd", qsgd_levels=15,
               link_policy="all")
# the multi-rank runs: (name, knobs, method), each 2 own-mode rounds —
# the hierarchy (gathers, moments, features, the two-stage sums, the
# client wire's per-rank noise), the slot scatter, the unsegmented sum
RUNS = (("defense", DEFENSE, "cost_trustfl"),
        ("krum", dict(HEADLINE, attack="sign_flip"), "krum"),
        ("fltrust", HEADLINE, "fltrust"))
ROUNDS = 2
# the global ranks of the subgroup run (not the lowest ones, so a rank's
# place in the subgroup differs from its global rank)
PAIR = (2, 5)


def narrow(data):
    """``data`` with every image cropped to its top-left 8 x 8 pixels: the
    paper's CNN at a narrow width (D = 53,578; the last layer keeps its
    1290 entries)."""
    crop = lambda x: np.ascontiguousarray(x[..., :8, :8, :])  # noqa: E731
    return replace(data, client_x=crop(data.client_x),
                   ref_x=crop(data.ref_x), test_x=crop(data.test_x))


def flat(params) -> np.ndarray:
    return np.concatenate([params[k].detach().cpu().numpy().ravel()
                           for k in sorted(params)])


def setup(knobs: dict, scenario=None):
    """(FLConfig with the scenario's overrides, topology, narrow data,
    the scenario) of the small topology at ``knobs``."""
    from repro_torch.configs.base import FLConfig
    from repro_torch.federated.simulation import make_data, make_topology
    from repro_torch.scenarios import get_scenario

    fl = FLConfig(**SMALL, **knobs)
    sc = get_scenario(scenario) if scenario is not None else None
    if sc is not None:
        fl = sc.apply(fl)
    return fl, make_topology(fl), narrow(make_data(fl, **SMALL_DATA)), sc


def record(rec: dict, eng, state, out, t: int) -> None:
    """Append round t's masks, float64 accounting, reputation, params
    and separability to ``rec``."""
    delivered = out.delivered.cpu().numpy()
    for name, value in (
            ("delivered", delivered),
            ("acct", eng.host_round_accounting(delivered[None], t0=t)[0]),
            ("rep", state.rep_ema.cpu().numpy()),
            ("params", flat(state.params)),
            ("feat_sep", state.feat_sep.cpu().numpy())):
        rec.setdefault(name, []).append(value)


def shard_rounds(knobs: dict, method: str, rounds: int = ROUNDS,
                 group=None) -> dict:
    """``rounds`` own-mode rounds of the sharded engine on this rank's
    block at ``knobs`` over ``group`` (default: the default group):
    {field: (T, ...) array} as :func:`record` gathers them."""
    from repro_torch.federated import engine as engine_mod
    from repro_torch.federated import sharded

    fl, topo, data, _ = setup(knobs)
    eng = sharded.engine_for(fl, topo, data, method, device=CPU, group=group)
    cd = eng.stage_data(engine_mod.make_client_data(fl, topo, data, 0,
                                                    device=CPU))
    state, rec = eng.init_state(0), {}
    for t in range(rounds):
        state, out = eng.step(state, cd, t)
        record(rec, eng, state, out, t)
    return {k: np.stack(v) for k, v in rec.items()}


def main(argv) -> int:
    rank, world, store, out = int(argv[1]), int(argv[2]), argv[3], argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        runs = {f"world/{name}": shard_rounds(knobs, method)
                for name, knobs, method in RUNS}
        pair = dist.new_group(list(PAIR))    # every rank takes part
        if rank in PAIR:
            runs.update({f"pair/{name}": shard_rounds(knobs, method,
                                                      group=pair)
                         for name, knobs, method in RUNS})
    finally:
        dist.destroy_process_group()
    np.savez(f"{out}_{rank}.npz", **{f"{name}/{k}": v
                                     for name, rec in runs.items()
                                     for k, v in rec.items()})
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    sys.exit(main(sys.argv))
