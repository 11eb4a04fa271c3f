"""Shared helpers of the port's round-parity tests: the reference
engine's per-round randomness re-derived from its key schedule and
handed to ``repro_torch``'s ``Engine.step`` in replay mode, the
comparison measures, and ``replay``, which chains replayed rounds of
one configuration against ``CompiledEngine.step``; likewise the
reference host loop's draws (``host_reference_draws``) and
``host_replay``, which chains rounds of the port's host loop against the
reference's ``FLServer(engine="host")``. Not a test module (leading
underscore)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import scenarios as jscenarios
from repro.compress.qsgd import QSGDCodec as JQSGDCodec
from repro.compress.topk import TopKCodec as JTopKCodec
from repro.configs.base import FLConfig as JFLConfig
from repro.federated import engine as jengine
from repro.federated.server import FLServer as JFLServer
from repro.federated.simulation import make_data as jmake_data
from repro.federated.simulation import make_topology as jmake_topology
from repro_torch import convert
from repro_torch import scenarios as tscenarios
from repro_torch.compress import QSGDCodec, TopKCodec
from repro_torch.configs.base import FLConfig
from repro_torch.federated import client as tclient
from repro_torch.federated import engine as tengine
from repro_torch.federated.server import FLServer as TFLServer
from repro_torch.federated.server import HostDraws
from repro_torch.federated.simulation import make_data as tmake_data
from repro_torch.federated.simulation import make_topology as tmake_topology
from repro_torch.kernels import ops


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def flat(params) -> np.ndarray:
    return np.concatenate([np.asarray(params[k]).ravel()
                           for k in sorted(params)])


def minibatch_idx(key, total: int, batch: int, n: int) -> np.ndarray:
    """(total, batch) indices exactly as the reference's LocalTrain draws
    them: ``split(key, total)``, then ``randint`` per step."""
    ks = jax.random.split(key, total)
    return np.asarray(jax.vmap(
        lambda k: jax.random.randint(k, (batch,), 0, n))(ks))


def _uniform_rows(key, ids, d: int) -> np.ndarray:
    """Row i: ``uniform(fold_in(key, ids[i]), (d,))`` — a QSGD codec's
    per-sender noise (``repro/compress/qsgd.py``)."""
    return np.asarray(jax.vmap(
        lambda r: jax.random.uniform(jax.random.fold_in(key, r), (d,)))(
            jnp.asarray(ids)))


def reference_draws(seed: int, t: int, n: int, steps: int, batch: int,
                    n_samples: int, ref_steps: int, n_ref: int, *,
                    d: int = 0, k: int = 0, edge_fold: int = 3,
                    client_sub=None) -> tengine.RoundDraws:
    """The reference engine's round-t randomness (engine.py: round_key,
    fold 131 for the selection noise and, on the flat path, the
    permutation, fold 137 for the dropout uniforms, split(key, N)[i] per
    client, the round key itself for the refs). With ``d`` > 0 also the
    QSGD wire noise: the client wire's ``fold_in(fold_in(key, 211),
    client)`` rows for all N clients — on the flat path, with
    ``client_sub`` (N,) the client's codec sub-fold (0 intra, 1 cross),
    ``fold_in(fold_in(fold_in(key, 211), sub), client)`` — and, with
    ``k`` > 0, the edge wire's ``fold_in(fold_in(fold_in(key, 223),
    edge_fold), cloud)`` rows."""
    key = jengine.round_key(jnp.int32(seed), jnp.int32(t))
    skey = jax.random.fold_in(key, 131)
    noise = jax.random.normal(skey, (n,), jnp.float32)
    perm = jax.random.permutation(skey, n)
    drop_u = jax.random.uniform(jax.random.fold_in(key, 137), (n,))
    keys = jax.random.split(key, n)
    cidx = np.stack([minibatch_idx(keys[i], steps, batch, n_samples)
                     for i in range(n)])
    ridx = minibatch_idx(key, ref_steps, tengine.REF_BATCH, n_ref)
    client_noise = edge_noise = None
    if d:
        ckey = jax.random.fold_in(key, 211)
        if client_sub is None:
            client_noise = _uniform_rows(ckey, np.arange(n), d)
        else:
            client_noise = np.stack([_uniform_rows(
                jax.random.fold_in(ckey, int(sub)), [i], d)[0]
                for i, sub in enumerate(client_sub)])
        client_noise = torch.tensor(client_noise)
    if d and k:
        ekey = jax.random.fold_in(jax.random.fold_in(key, 223), edge_fold)
        edge_noise = torch.tensor(_uniform_rows(ekey, np.arange(k), d))
    return tengine.RoundDraws(torch.tensor(np.asarray(noise)),
                              torch.tensor(cidx), torch.tensor(ridx),
                              client_noise=client_noise,
                              edge_noise=edge_noise,
                              perm=torch.tensor(np.asarray(perm)),
                              drop_u=torch.tensor(np.asarray(drop_u)))


def host_reference_draws(seed: int, t: int, n: int, steps: int, batch: int,
                         n_samples: int, ref_steps: int, n_ref: int, *,
                         d: int = 0, k: int = 0, edge_fold: int = 3,
                         client_sub=None, attack_shape=None) -> HostDraws:
    """The reference host loop's round-t tensor randomness
    (``repro/federated/server.py:_run_round_host``). Its key
    ``PRNGKey(seed·7919 + t)`` is the engine's round key, so its draws are
    ``reference_draws``' own: each delivered client's minibatches from
    ``split(key, N)[client]``, the clouds' one shared reference schedule
    from ``key`` itself, the client wire's QSGD noise from ``fold_in(key,
    211)`` per sender (with ``client_sub``: sub-fold 0 intra / 1 cross,
    the flat path's two passes) and the edge wire's from ``fold_in(key,
    223)``, then ``edge_fold``, per cloud. Selection and delivery come
    from the round's numpy generator in either loop. With
    ``attack_shape`` (delivered rows, D): the gaussian attack's
    ``normal(key, attack_shape)``."""
    r = reference_draws(seed, t, n, steps, batch, n_samples, ref_steps,
                        n_ref, d=d, k=k, edge_fold=edge_fold,
                        client_sub=client_sub)
    attack = None
    if attack_shape is not None:
        key = jax.random.PRNGKey(seed * 7919 + t)
        attack = torch.tensor(np.asarray(jax.random.normal(
            key, tuple(attack_shape), jnp.float32)))
    return HostDraws(r.client_idx, r.ref_idx, r.client_noise, r.edge_noise,
                     attack)


# ---------------------------------------------------------------------------
# replayed rounds: the port's Engine.step against CompiledEngine.step

# tests/test_determinism.py's small topology; 32x32x3 inputs keep the
# CNN at full width (D = 545,098)
SMALL = dict(n_clouds=3, clients_per_cloud=4, clients_per_round=6,
             local_epochs=1, local_batch=8, ref_samples=16)
SMALL_DATA = dict(n_samples=600, samples_per_client=16)


class WireSpy:
    """Captures the input y of every lossy round trip — the reference's
    through ``jax.debug.callback``, the port's directly — so that a
    replay can tell which entries the two runs' wires treat
    differently."""

    def __init__(self, monkeypatch):
        self.j, self.t = [], []
        self.topk_j, self.topk_t = JTopKCodec.roundtrip, TopKCodec.roundtrip
        for jcls, tcls, tname in ((JTopKCodec, TopKCodec, "roundtrip"),
                                  (JQSGDCodec, QSGDCodec,
                                   "roundtrip_residual")):
            monkeypatch.setattr(jcls, "roundtrip",
                                self._spy_j(jcls.roundtrip))
            monkeypatch.setattr(tcls, tname, self._spy_t(getattr(tcls,
                                                                 tname)))

    def _spy_j(self, orig):
        def spy(codec, x, key, row_ids=None):
            jax.debug.callback(lambda v: self.j.append(np.asarray(v)), x,
                               ordered=True)
            return orig(codec, x, key, row_ids)
        return spy

    def _spy_t(self, orig):
        def spy(codec, x, noise=None):
            self.t.append(x.detach().clone().numpy())
            return orig(codec, x, noise)
        return spy

    def pairs(self, intra_rows=None):
        """[(y_reference, y_port)] of this round, matched by row count
        (the client wire's m rows, the edge wire's K), then cleared. The
        flat client wire under ``all`` is one round trip in the port and
        two passes in the reference (intra, then cross, each masked):
        its reference y is the first pass's on ``intra_rows`` and the
        second's elsewhere."""
        out = []
        for yt in self.t:
            ys = [y for y in self.j if y.shape == yt.shape]
            if len(ys) == 2:
                ys = [np.where(intra_rows[:, None], ys[0], ys[1])]
            (yj,) = ys
            out.append((yj, yt))
        assert len(self.j) == len(self.t) + sum(
            len([y for y in self.j if y.shape == yt.shape]) - 1
            for yt in self.t)
        self.j.clear()
        self.t.clear()
        return out


def wire_flips(codec, yj: np.ndarray, yt: np.ndarray, noise) -> tuple:
    """(flips, bound): the entries one run's codec treats differently
    from the other's on inputs ``yj`` and ``yt``, and the count allowed.
    Top-k: a mask flip (≤ 0.1% of the kept entries) or a kept value on
    the other side of an fp16 rounding boundary (≤ 1% in all). QSGD: a
    level flip, |v| + u within rounding of an integer (≤ 1e-4 of the
    entries)."""
    if isinstance(codec, TopKCodec):
        k_keep = codec.k_for(yj.shape[1])

        def keep(y):
            return np.abs(y) >= np.sort(np.abs(y), 1)[:, -k_keep, None]
        kj, kt = keep(yj), keep(yt)
        mask_flips = kj != kt
        assert mask_flips.sum() <= 1e-3 * k_keep * len(yj)
        f16 = yj.astype(np.float16) != yt.astype(np.float16)
        return mask_flips | (kj & kt & f16), 1e-2 * k_keep * len(yj)

    def levels(y):
        yy = torch.tensor(y)
        return ops.stochastic_quantize(yy, torch.amax(yy.abs(), dim=1),
                                       noise, levels=codec.levels).numpy()
    return levels(yj) != levels(yt), 1e-4 * yj.size


def replay(cfg: dict, method: str = "cost_trustfl", scenario=None,
           rounds: int = 3, monkeypatch=None, seed: int = 0):
    """``rounds`` chained rounds of the reference's ``CompiledEngine.step``
    and of the port's ``Engine.step`` replaying its draws, from the same
    initial state, at ``cfg`` (with ``scenario``'s overrides and hooks,
    a registered name). Each round: delivered masks, float64 bytes and $
    exact; reputation, params and feature separability within 1e-4
    relative. With a lossy wire (``monkeypatch`` given): top-k is exact
    on the reference's own input, and the EF residuals agree within 5e-2
    in all. Until a wire input row is more than 1e-4 apart (a LocalTrain
    ReLU input within rounding of 0, ``ROADMAP.md`` C.5: from then on
    the two wires see other inputs), the entries the two wires treat
    differently (``wire_flips``) are bounded and the residuals agree
    within 1e-4 off their columns. Returns the per-round drifts."""
    jscen = tscen = None
    jfl, tfl = JFLConfig(**cfg), FLConfig(**cfg)
    if scenario is not None:
        jscen, tscen = (jscenarios.get_scenario(scenario),
                        tscenarios.get_scenario(scenario))
        jfl, tfl = jscen.apply(jfl), tscen.apply(tfl)
    topo = jmake_topology(jfl)
    jstatic = jengine.static_from(jfl, topo, method, jscen)
    spy = WireSpy(monkeypatch) if monkeypatch is not None else None
    # a private build (not the lru-cached one) so a spy is traced in
    eng = (jengine._compiled.__wrapped__(jstatic, None) if spy
           else jengine.compiled(jstatic))
    jcd = jengine.make_client_data(jfl, topo, jmake_data(
        jfl, "cifar10", seed=0, **SMALL_DATA), seed)
    jstate = eng.init_state(seed)

    ttopo = tmake_topology(tfl)
    teng = tengine.Engine(tengine.static_from(tfl, ttopo, method, tscen),
                          torch.device("cpu"))
    tcd = tengine.make_client_data(tfl, ttopo, tmake_data(tfl, **SMALL_DATA),
                                   seed, device=torch.device("cpu"))
    tstate = convert.round_state_from_numpy(
        {k: np.asarray(v) for k, v in jstate.params.items()},
        np.asarray(jstate.rep_ema), np.asarray(jstate.res_edge), seed,
        device=torch.device("cpu"), res_client=np.asarray(jstate.res_client),
        feat_sep=np.asarray(jstate.feat_sep))
    steps, ref_steps = teng.schedule(tcd)
    n, k, d = topo.n_clients, topo.n_clouds, teng.d_params
    lp = teng.link_policy
    noisy = teng.client_wire_noise or teng.edge_wire_noise
    flipped = np.zeros(d, bool)
    diverged = False
    drifts = []
    for t in range(rounds):
        jstate, jout = eng.step(jstate, jcd, t)
        jax.block_until_ready(jstate)
        jax.effects_barrier()
        draws = reference_draws(
            seed, t, n, steps, jfl.local_batch,
            SMALL_DATA["samples_per_client"], ref_steps, jfl.ref_samples,
            d=d if noisy else 0, k=k, edge_fold=teng.edge_noise_fold,
            client_sub=None if teng.hier else teng.client_sub)
        sel_idx = torch.nonzero(teng.select(
            tstate.rep_ema, teng.static.c_cross_at(t), draws)).reshape(-1)
        tstate, tout = teng.step(tstate, tcd, t, draws)

        delivered = np.asarray(jout.delivered)
        assert np.array_equal(tout.delivered.numpy(), delivered), t
        assert np.array_equal(
            teng.host_round_accounting(delivered[None], t0=t),
            eng.host_round_accounting(delivered[None], t0=t)), t
        drift = dict(rep=rel(tstate.rep_ema.numpy(), jstate.rep_ema),
                     params=rel(flat(tstate.params), flat(jstate.params)))
        if teng.static.multi_features:
            drift["feat_sep"] = rel(tstate.feat_sep.numpy(), jstate.feat_sep)
        assert max(drift.values()) <= 1e-4, (t, drift)

        if spy is not None:
            drift["flips"] = 0
            intra_rows = (teng.cloud_of[sel_idx] == teng.agg).numpy()
            for yj, yt in spy.pairs(intra_rows):
                edge = yj.shape[0] == k and teng.edge_wire_active
                # the lossy codec of that wire (one per wire here)
                codec = lp.cross if not lp.cross.is_identity else lp.intra
                noise = None
                if codec.needs_noise:
                    noise = (draws.edge_noise if edge
                             else draws.client_noise[sel_idx])
                if isinstance(codec, TopKCodec):      # exact on one input
                    x_j = np.asarray(spy.topk_j(JTopKCodec(codec.ratio),
                                                jnp.asarray(yj), None))
                    x_t = spy.topk_t(codec, torch.tensor(yj)).numpy()
                    assert np.array_equal(x_t, x_j), t
                # a wire input row more than 1e-4 apart: a ReLU input
                # within rounding of 0 in one run's LocalTrain routes an
                # O(1) gradient through that run only (ROADMAP.md C.5),
                # upstream of the wire; the wires then see other inputs
                apart = [rel(a, b) for a, b in zip(yt, yj)]
                if max(apart) > 1e-4:
                    drift["rows_apart"] = [f"{a:.1e}" for a in apart]
                    diverged = True
                if not diverged:
                    flips, allowed = wire_flips(codec, yj, yt, noise)
                    assert flips.sum() <= allowed, (t, int(flips.sum()))
                    flipped |= flips.any(axis=0)
                    drift["flips"] += int(flips.sum())
        for name in ("res_client", "res_edge"):
            a = getattr(tstate, name).numpy()
            b = np.asarray(getattr(jstate, name))
            assert a.shape == b.shape, name
            if a.size:
                off = rel(a[:, ~flipped], b[:, ~flipped])
                drift[name] = off
                assert diverged or off <= 1e-4, (t, name, off)
                assert rel(a, b) <= 5e-2, (t, name)
        drifts.append(drift)
    return drifts


# ---------------------------------------------------------------------------
# replayed rounds: the port's host loop against the reference's

def host_replay(cfg: dict, method: str = "cost_trustfl", scenario=None,
                rounds: int = 3, seed: int = 0, monkeypatch=None):
    """``rounds`` chained rounds of the reference's host loop
    (``FLServer(engine="host")``) and of the port's
    (``FLServer(engine="host", device="cpu")``) replaying its draws
    (``host_reference_draws``), from the reference server's initial
    params, at ``cfg`` with ``scenario`` (a registered name, or a
    (reference, port) pair of ``Scenario`` objects) and its overrides.
    Each round: the delivered masks, float64 bytes and $ exact;
    reputation, params and feature separability within 1e-4 relative.
    The EF residuals are held to 5e-2: an entry of a wire input within
    rounding of an fp16 boundary, a top-k threshold or a QSGD level
    takes the other value in one run (``ROADMAP.md`` C.3–C.4), which
    ``replay`` isolates with its spy.

    With ``monkeypatch`` given, both LocalTrains of the delivered clients
    are spied: a client update more than 1e-4 apart (``rows_apart``: a
    ReLU or max-pool input within rounding of its switch point routes an
    O(1) gradient through one run only, ``ROADMAP.md`` C.5) means the
    runs train from other inputs from then on, and the 1e-4 contract
    gives way to 5e-2 from the round after. Returns the per-round
    drifts."""
    jscen = tscen = None
    if isinstance(scenario, str):
        jscen = jscenarios.get_scenario(scenario)
        tscen = tscenarios.get_scenario(scenario)
    elif scenario is not None:
        jscen, tscen = scenario
    jfl, tfl = JFLConfig(**cfg), FLConfig(**cfg)
    if jscen is not None:
        jfl, tfl = jscen.apply(jfl), tscen.apply(tfl)
    jserver = JFLServer(jfl, jmake_topology(jfl), jmake_data(
        jfl, "cifar10", seed=0, **SMALL_DATA), method=method, seed=seed,
        scenario=jscen, engine="host")
    tserver = TFLServer(tfl, tmake_topology(tfl),
                        tmake_data(tfl, **SMALL_DATA), method=method,
                        seed=seed, scenario=tscen, device="cpu",
                        engine="host")
    assert tserver.engine_resolved == "host"
    tserver.params = convert.params_from_numpy(
        {k: np.asarray(v) for k, v in jserver.params.items()},
        device=torch.device("cpu"))
    trained = {"j": [], "t": []}
    if monkeypatch is not None:
        j_train, t_train = jserver._train_selected, tclient.local_train

        def j_spy(*args):
            out = j_train(*args)
            trained["j"].append(np.asarray(jengine.ravel_rows(out)))
            return out

        def t_spy(*args, **kw):
            out = t_train(*args, **kw)
            trained["t"].append(tengine.ravel_rows(out).numpy())
            return out
        jserver._train_selected = j_spy
        monkeypatch.setattr(tclient, "local_train", t_spy)
    teng = tserver._eng
    steps, ref_steps = teng.schedule(tserver._eng_data)
    n, k, d = teng.n, teng.k, teng.d_params
    noisy = teng.client_wire_noise or teng.edge_wire_noise
    drifts = []
    diverged = False
    for t in range(rounds):
        jm = jserver.run_round(t)
        delivered = np.asarray(jm.selected)
        draws = host_reference_draws(
            seed, t, n, steps, jfl.local_batch,
            SMALL_DATA["samples_per_client"], ref_steps, jfl.ref_samples,
            d=d if noisy else 0, k=k, edge_fold=teng.edge_noise_fold,
            client_sub=None if teng.hier else teng.client_sub,
            attack_shape=((int(delivered.sum()), d)
                          if jfl.attack == "gaussian" else None))
        tm = tserver.run_round(t, draws)
        assert np.array_equal(tm.selected, delivered), t
        assert (tm.cost, tm.extra["intra_bytes"], tm.extra["cross_bytes"]
                ) == (jm.cost, jm.extra["intra_bytes"],
                      jm.extra["cross_bytes"]), t
        drift = dict(rep=rel(tm.reputation, jm.reputation),
                     params=rel(flat(convert.params_to_numpy(tserver.params)),
                                flat(jserver.params)))
        if jserver._feat_sep is not None:
            drift["feat_sep"] = rel(tserver._feat_sep.numpy(),
                                    jserver._feat_sep)
            drift["feat_weights"] = rel(tm.extra["feat_weights"],
                                        jserver._feat_weights)
        assert max(drift.values()) <= (5e-2 if diverged else 1e-4), (t, drift)
        for name in ("_res_client", "_res_edge"):
            a, b = getattr(tserver, name), getattr(jserver, name)
            assert (a is None) == (b is None), name
            if a is not None:
                drift[name] = rel(a.numpy(), b)
                assert drift[name] <= 5e-2, (t, name, drift[name])
        if trained["j"]:
            # the clients' LocalTrain is each loop's first this round
            apart = [rel(a, b) for a, b in zip(trained["t"][0],
                                                trained["j"][0])]
            drift["rows_apart"] = max(apart)
            diverged = diverged or max(apart) > 1e-4
            trained["j"].clear()
            trained["t"].clear()
        drifts.append(drift)
    return drifts
