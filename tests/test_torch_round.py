"""The port's round against the reference round engine on identical
inputs: the CNN and LocalTrain with carried weights, then three chained
rounds of ``repro_torch``'s ``Engine.step`` in replay mode against
``repro``'s ``CompiledEngine.step`` (README headline config: label_flip,
top-k 0.1, cross_only) and five at the default ``FLConfig``, plus the
port's entry-point contract.

Tolerances: masks, bytes and $ exact; reputation and params within 1e-4
relative L2 (the reference's own cross-engine contract). The edge
residuals are held at 1e-4 everywhere except at entries that one run's
wire rounds or masks differently from the other's (see
``test_three_rounds_match_reference``).
"""
import ast
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compress.topk import TopKCodec as JTopKCodec
from repro.configs.base import FLConfig as JFLConfig
from repro.federated import client as jclient
from repro.federated import engine as jengine
from repro.federated.simulation import make_data as jmake_data
from repro.federated.simulation import make_topology as jmake_topology
from _torch_replay import flat as _flat
from _torch_replay import minibatch_idx as _minibatch_idx
from _torch_replay import SMALL as _SMALL
from _torch_replay import reference_draws as _reference_draws
from _torch_replay import rel as _rel
from _torch_replay import replay as _replay
from repro_torch import convert
from repro_torch.compress.topk import TopKCodec
from repro_torch.configs.base import FLConfig
from repro_torch.federated import client as tclient
from repro_torch.federated import engine as tengine
from repro_torch.federated.simulation import (make_data, make_topology,
                                              run_simulation)
from repro_torch.scenarios import Scenario

CPU = torch.device("cpu")
ROOT = pathlib.Path(__file__).resolve().parents[1]

# tests/test_determinism.py's small topology at the README headline config;
# 32x32x3 inputs keep the CNN at full width (D = 545,098)
_FL = dict(n_clouds=3, clients_per_cloud=4, clients_per_round=6,
           local_epochs=1, local_batch=8, ref_samples=16,
           attack="label_flip", malicious_frac=0.3, compressor="topk",
           compress_ratio=0.1, link_policy="cross_only")
_DATA = dict(n_samples=600, samples_per_client=16)


def test_cnn_and_local_train_match_reference():
    """Forward logits and one LocalTrain (2 SGD steps, 3 clients) with
    weights carried by params_from_numpy; fp32 sums in another order, so
    1e-4 relative (logits 1e-5).

    A ReLU input within rounding of 0 (|x| ~ 1e-7) can be positive in
    one framework and negative in the other, which routes an O(1)
    gradient through one run only (data seed 0 has one such conv1 input
    on client 0: its conv1_w update then differs by 5e-3). Data seed 1
    has none in these minibatches."""
    params = jclient.cnn_init(jax.random.PRNGKey(3), (32, 32, 3), 10)
    np_params = {k: np.asarray(v) for k, v in params.items()}
    tparams = convert.params_from_numpy(np_params, device=CPU)
    back = convert.params_to_numpy(tparams)
    assert list(back) == sorted(np_params)
    assert all(np.array_equal(back[k], np_params[k]) for k in np_params)
    rng = np.random.default_rng(1)
    x = rng.random((3, 16, 32, 32, 3), np.float32)
    y = rng.integers(0, 10, (3, 16))

    logits = jclient.cnn_apply(params, jnp.asarray(x[0]))
    tlogits = tclient.cnn_apply(tparams, torch.as_tensor(x[0]))
    np.testing.assert_allclose(tlogits.detach().numpy(), logits,
                               rtol=1e-5, atol=1e-5)

    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    upd = jax.vmap(lambda xx, yy, kk: jclient.local_train(
        params, xx, yy, kk, epochs=1, batch=8, lr=0.01))(
            jnp.asarray(x), jnp.asarray(y), keys)
    idx = np.stack([_minibatch_idx(keys[i], 2, 8, 16) for i in range(3)])
    tupd = tclient.local_train(tparams, torch.as_tensor(x),
                               torch.as_tensor(y), torch.as_tensor(idx),
                               lr=0.01)
    for k in params:
        assert _rel(tupd[k].numpy(), upd[k]) <= 1e-4, k


def test_three_rounds_match_reference(monkeypatch):
    """Three chained rounds from the same initial state, replaying the
    reference's draws.

    Wire caveat: float32 sums taken in another order move the pre-top-k
    edge uplink y by ~1e-6 relative. A kept entry lying within that of
    an fp16 rounding boundary rounds the other way in one run, so its
    edge residual y - fp16(y) flips sign (one fp16 ulp); an entry within
    that of the top-k threshold would flip the mask and put ~thr into
    one run's residual only. Either way the residuals differ by ~1e-4
    relative in total (measured: 7e-5 after round 0, 1.5e-4 after round
    2, from 181 / 574 / 704 fp16 flips and no mask flip). The test
    proves that this is the only source: fed the reference's own y, the
    port's top-k + fp16 round trip equals the reference's exactly; the
    residuals agree within 1e-4 off the entries the two wires treat
    differently; those entries are bounded (mask flips ≤ 0.1% of k,
    all ≤ 1% of k per round) and the total drift ≤ 1e-3."""
    captured_j, captured_t = [], []
    orig_j, orig_t = JTopKCodec.roundtrip, TopKCodec.roundtrip

    def spy_j(self, x, key, row_ids=None):
        jax.debug.callback(lambda v: captured_j.append(np.asarray(v)), x)
        return orig_j(self, x, key, row_ids)

    def spy_t(self, x, noise=None):
        captured_t.append(x.clone())
        return orig_t(self, x, noise)

    monkeypatch.setattr(JTopKCodec, "roundtrip", spy_j)
    monkeypatch.setattr(TopKCodec, "roundtrip", spy_t)

    jfl, tfl = JFLConfig(**_FL), FLConfig(**_FL)
    topo = jmake_topology(jfl)
    # a private build (not the lru-cached one) so the spy is traced in
    eng = jengine._compiled.__wrapped__(
        jengine.static_from(jfl, topo, "cost_trustfl"), None)
    jdata = jmake_data(jfl, "cifar10", seed=0, **_DATA)
    jcd = jengine.make_client_data(jfl, topo, jdata, 0)
    jstate = eng.init_state(0)

    ttopo = make_topology(tfl)
    teng = tengine.Engine(tengine.static_from(tfl, ttopo), CPU)
    tcd = tengine.make_client_data(tfl, ttopo, make_data(tfl, **_DATA), 0,
                                   device=CPU)
    tstate = convert.round_state_from_numpy(
        {k: np.asarray(v) for k, v in jstate.params.items()},
        np.asarray(jstate.rep_ema), np.asarray(jstate.res_edge), 0,
        device=CPU)
    steps, ref_steps = teng.schedule(tcd)
    k_keep = TopKCodec(0.1).k_for(teng.d_params)
    cross_rows = np.arange(topo.n_clouds) != topo.aggregator_cloud
    flipped = np.zeros((topo.n_clouds, teng.d_params), bool)

    for t in range(3):
        jstate, jout = eng.step(jstate, jcd, t)
        jax.block_until_ready(jstate)
        jax.effects_barrier()
        draws = _reference_draws(0, t, topo.n_clients, steps,
                                 jfl.local_batch, _DATA["samples_per_client"],
                                 ref_steps, jfl.ref_samples)
        tstate, tout = teng.step(tstate, tcd, t, draws)

        delivered = np.asarray(jout.delivered)
        assert np.array_equal(tout.delivered.numpy(), delivered)
        assert np.array_equal(
            teng.host_round_accounting(delivered[None]),
            eng.host_round_accounting(delivered[None], t0=t))
        assert _rel(tstate.rep_ema.numpy(), jstate.rep_ema) <= 1e-4
        assert _rel(_flat(tstate.params), _flat(jstate.params)) <= 1e-4

        # the top-k itself is exact on the reference's own input
        y_j = captured_j[-1]
        x_j = np.asarray(orig_j(JTopKCodec(0.1), jnp.asarray(y_j), None))
        x_t = orig_t(TopKCodec(0.1), torch.tensor(y_j)).numpy()
        assert np.array_equal(x_t, x_j)
        # entries the two runs' wires treat differently on the
        # cross-cloud rows: top-k mask flips, and kept values on either
        # side of an fp16 rounding boundary
        y_t = captured_t[-1].numpy()
        keep_j = np.abs(y_j) >= np.sort(np.abs(y_j), 1)[:, -k_keep, None]
        keep_t = np.abs(y_t) >= np.sort(np.abs(y_t), 1)[:, -k_keep, None]
        f16_differs = y_j.astype(np.float16) != y_t.astype(np.float16)
        mask_flips = (keep_j != keep_t) & cross_rows[:, None]
        flips = mask_flips | (keep_j & keep_t & f16_differs
                              & cross_rows[:, None])
        assert mask_flips.sum() <= 1e-3 * k_keep * cross_rows.sum()
        assert flips.sum() <= 1e-2 * k_keep * cross_rows.sum()
        flipped |= flips

        res_t, res_j = tstate.res_edge.numpy(), np.asarray(jstate.res_edge)
        print(f"round {t}: rep {_rel(tstate.rep_ema.numpy(), jstate.rep_ema):.2e}"
              f" params {_rel(_flat(tstate.params), _flat(jstate.params)):.2e}"
              f" res_edge {_rel(res_t, res_j):.2e}; {int(mask_flips.sum())}"
              f" top-k mask flips, {int(flips.sum())} entries in all")
        assert _rel(res_t[~flipped], res_j[~flipped]) <= 1e-4
        assert _rel(res_t, res_j) <= 1e-3


def test_default_config_five_rounds_match_reference():
    """The north star's main path, the default ``FLConfig``
    (Cost-TrustFL, no codec, no attack, scalar trust), at the small
    topology: five replayed rounds, masks, bytes and $ exact, reputation
    and params within 1e-4 (no wire, so nothing to isolate)."""
    fl = FLConfig(**_SMALL)
    assert (fl.aggregator, fl.compressor, fl.attack, fl.trust_features) == (
        "cost_trustfl", "none", "none", "scalar")
    drifts = _replay(dict(_SMALL), rounds=5)
    for t, dr in enumerate(drifts):
        print(f"default round {t}: {dr}")
    assert len(drifts) == 5


def test_run_simulation_cpu_smoke():
    fl = FLConfig(**_FL)
    r = run_simulation(fl, rounds=2, eval_every=1, device="cpu",
                       data=make_data(fl, **_DATA))
    assert r.rounds == [1, 2] and len(r.accuracy) == 2
    assert 0.0 <= r.final_accuracy <= 1.0
    assert np.all(np.isfinite(r.reputation))
    assert r.total_cost > 0 and r.cross_bytes > 0 and r.intra_bytes > 0


def test_default_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fl = FLConfig(**_FL)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_simulation(fl, rounds=1, data=make_data(fl, **_DATA))


def _host_hook(*args):
    raise AssertionError("a host hook is never called by the engine")


# what no round loop of the port runs: the reference's mesh-sharded engine
# (every method), and the round engine forced onto what only the host
# round loop runs (dropout under an order statistic, host hooks without
# a jit_hooks twin)
@pytest.mark.parametrize("override", [
    *(dict(aggregator=m, engine="shard") for m in tengine.METHODS),
    dict(aggregator="krum", scenario="dropout", engine="jit"),
    dict(aggregator="trimmed_mean", scenario="dropout", engine="jit"),
    dict(aggregator="median", scenario="dropout", engine="jit"),
    dict(scenario=Scenario("host_deliver", "environment",
                           deliver=_host_hook), engine="jit"),
    dict(scenario=Scenario("host_round_start", "environment",
                           on_round_start=_host_hook), engine="jit"),
    dict(aggregator="fedavg",
         scenario=Scenario("host_malice", "adaptive",
                           malicious_now=_host_hook), engine="jit")])
def test_unported_configs_raise(override):
    override = dict(override)
    scenario = override.pop("scenario", None)
    engine = override.pop("engine")
    fl = FLConfig(**{**_FL, **override})
    err, match = ((NotImplementedError, "ROADMAP queue A item 6")
                  if engine == "shard" else (ValueError, "not jittable"))
    with pytest.raises(err, match=match):
        run_simulation(fl, rounds=1, device="cpu", scenario=scenario,
                       data=make_data(fl, **_DATA), engine=engine)


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (f, mod)
