"""The Cost-TrustFL round as ``Engine.step(state, data, t) -> (state,
out)``: the port of the reference's ``round_step``
(``repro/federated/engine.py``), its hierarchical branch
(``method="cost_trustfl"``) and its flat branch (the baselines
``fedavg``, ``krum``, ``trimmed_mean``, ``median`` and ``fltrust``).

One hierarchical round: Eq. 10 selection (per-cloud quota + tie-break
noise), local training of the selected clients and of the per-cloud references, the
update attack on the active malicious rows, the client→edge wire (error
feedback, residuals per sender), Eq. 7 contribution with the median
damp and, under ``trust_features="multi"``, the multi-feature gate,
Eq. 8–9 reputation EMA, Eq. 11 trust against the client's own-cloud
reference, Eq. 12 rescale + Eq. 13 per-cloud aggregate, the edge→global
wire (error feedback), the Eq. 6 β combine, and byte-exact accounting.
The trust stage (Eq. 7 with the damp, the gate, Eq. 8–9, Eq. 11) is one
launch of the ``trust_stage`` kernel, Eq. 12 + 13 go through
``weighted_agg``, and the wires through ``topk_mask`` (top-k) or
``stochastic_quantize`` (QSGD).

One flat round: a uniform draw of the selected set, local training, the
attack, each client's one uplink through the intra codec (clients of the
aggregator's cloud) or the cross codec (the rest), then the method's
aggregate of ``repro_torch.core.robust`` (FLTrust through
``weighted_agg``). A scenario's :class:`~repro_torch.scenarios.JitHooks`
add dropout (non-delivered rows are masked, never dropped from the
fixed-size selected set), a malice warmup and a ``c_cross`` price
schedule.

Round randomness is a :class:`RoundDraws`: the selection noise (flat:
the permutation), the dropout uniforms, the minibatch indices of the
clients and of the reference training, and —
where the configuration reads them — the wires' QSGD noise and the
gaussian attack's normals. Own mode (:meth:`Engine.draws`) draws them
from ``torch.Generator`` streams on the device seeded from
``(seed·7919 + t, fold, ...)``; the wire noise comes from one stream per
SENDER (client id, or cloud on the edge wire), drawn after selection
for the selected senders only, so a client's noise never depends on its
row position. Replay mode takes them from the caller, e.g. re-derived
from the reference's key schedule.

The host round loop (``FLServer(engine="host")``) runs what
:func:`supports` leaves out — dropout under an order statistic, host
hooks without ``jit_hooks`` — with an :class:`Engine` of its config
without the scenario for its wires, payloads and own-mode streams; the
mesh-sharded engine (``federated.sharded``, ``engine="shard"``) spreads
the clients over the ranks of a process group; :func:`resolve_engine`
routes between the three.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.compress import build_link_policy, ef_step_masked
from repro_torch.configs.base import FLConfig
from repro_torch.core import features as feats_mod
from repro_torch.core.attacks import (NOISY_ATTACKS, UPDATE_ATTACKS,
                                      apply_update_attack)
from repro_torch.core import robust
from repro_torch.core.cost import (CostModel, hierarchical_unit_costs_torch,
                                   round_bytes_torch)
from repro_torch.core.fl_types import CloudTopology
from repro_torch.core.reputation import ReputationState
from repro_torch.core.selection import (exploration_quota, select_clients,
                                        selected_count)
from repro_torch.core.trust import cloud_trust
from repro_torch.data.pipeline import FederatedData
from repro_torch.federated import client as client_mod
from repro_torch.kernels import ops
from repro_torch.scenarios.base import JitHooks, Scenario
from repro_torch.telemetry import taps as taps_mod
from repro_torch.telemetry.taps import TapSpec

Tensor = torch.Tensor

_GB = 1024.0 ** 3
REF_BATCH = 32          # reference LocalTrain batch (client default)
EPS = 1e-12

METHODS = ("cost_trustfl", "fedavg", "krum", "trimmed_mean", "median",
           "fltrust")
# aggregators whose math is a 0-weighted sum over masked rows, so safe
# when dropout zeroes the non-delivered rows of the selected set; the
# order statistics would read the zero rows as clients
MASKED_DELIVERY_OK = ("cost_trustfl", "fedavg", "fltrust")

# own-mode stream tags (selection, dropout and the wires keep the
# reference's fold numbers; the flat client wire's codec sub-folds are
# 0 = intra, 1 = cross, the edge wire's 2 = intra, 3 = cross)
_FOLD_SELECT = 131
_FOLD_DROPOUT = 137
_FOLD_TRAIN = 1
_FOLD_REF = 2
_FOLD_ATTACK = 239
_FOLD_CLIENT_WIRE = 211
_FOLD_EDGE_WIRE = 223

# the trust path's g^(L): the final dense layer, weight then bias (the
# reference's last two template leaves by insertion order)
LAST_LAYER = ("fc2_w", "fc2_b")


class RoundState(NamedTuple):
    """Everything a round mutates. ``res_client`` — the largest buffer,
    N × D — is updated IN PLACE by :meth:`Engine.step` (the reference's
    is a fresh array each round); every other field is a new tensor."""
    params: Dict[str, Tensor]    # model parameters (JAX layout, sorted keys)
    rep_ema: Tensor              # (N,) Eq. 9 reputation EMA
    res_client: Tensor           # (N, D) EF residuals, client uplinks ((0,) when inactive)
    res_edge: Tensor             # (K, D) EF residuals, edge uplinks ((0,) when inactive)
    cum_cost: Tensor             # () running $ (float32; hosts reduce f64)
    cum_intra_bytes: Tensor      # () running intra-class wire bytes
    cum_cross_bytes: Tensor      # () running cross-cloud wire bytes
    feat_sep: Tensor             # (F,) per-feature separability EMA ((0,) under "scalar")
    seed: int                    # own-mode stream root


class RoundOut(NamedTuple):
    """Per-round metrics (:meth:`Engine.run` stacks each to (T, ...))."""
    delivered: Tensor            # (N,) bool — selected AND delivered
    rep: Tensor                  # (N,) post-update reputation EMA
    cost: Tensor                 # () $ this round (float32 mirror)
    intra_bytes: Tensor          # () wire bytes, intra-class
    cross_bytes: Tensor          # () wire bytes, cross-cloud
    params_l2: Tensor            # () float32 L2 over all params after the update
    feat_weights: Tensor         # (F,) feature mixing weights ((0,) under "scalar")


class ClientData(NamedTuple):
    """Round-invariant device inputs."""
    client_x: Tensor             # (N, S, H, W, C)
    client_y: Tensor             # (N, S) int64 labels (already poisoned)
    ref_x: Tensor                # (K, R, H, W, C) per-cloud reference sets
    ref_y: Tensor                # (K, R)
    malicious: Tensor            # (N,) bool static adversary set


class RoundDraws(NamedTuple):
    """One round's randomness. The optional fields are read only where
    the configuration needs them; ``None`` there means "draw in own mode
    after selection" (or, for ``select_noise``/``perm``, "not this
    branch's")."""
    select_noise: Optional[Tensor]  # (N,) standard normals (Eq. 10 tie-break; hierarchical)
    client_idx: Tensor           # (N, steps, batch) minibatch indices
    ref_idx: Tensor              # (ref_steps, REF_BATCH), shared by clouds
    client_noise: Optional[Tensor] = None   # (N, D) U[0,1), client wire, row = client id
    edge_noise: Optional[Tensor] = None     # (K, D) U[0,1), edge wire, row = cloud
    attack_noise: Optional[Tensor] = None   # (m, D) N(0,1), gaussian attack, row = selected row
    perm: Optional[Tensor] = None           # (N,) permutation, flat selection perm[:m]
    drop_u: Optional[Tensor] = None         # (N,) U[0,1), dropout (delivered iff >= p_drop)


@dataclass(frozen=True)
class EngineStatic:
    """The engine-relevant slice of (FLConfig, topology, scenario)."""
    method: str
    cloud_of: Tuple[int, ...]
    n_clouds: int
    aggregator_cloud: int
    input_shape: Tuple[int, ...]
    n_classes: int
    clients_per_round: int
    cost_lambda: float
    c_intra: float
    c_cross: float
    attack: str
    attack_scale: float
    gaussian_sigma: float
    attack_z: float
    local_epochs: int
    local_batch: int
    lr: float
    server_lr: float
    ema_gamma: float
    malicious_frac: float
    compressor: str
    compress_ratio: float
    qsgd_levels: int
    link_policy: str
    p_drop: float
    malice_warmup: int
    price_multipliers: Tuple[float, ...]
    trust_features: str

    @property
    def hierarchical(self) -> bool:
        return self.method == "cost_trustfl"

    @property
    def multi_features(self) -> bool:
        """The multi-feature gate refines Cost-TrustFL's Eq. 7; the flat
        baselines have no Eq. 7 for it to gate."""
        return self.hierarchical and self.trust_features == "multi"

    def c_cross_at(self, t: int) -> float:
        """Round t's float32 cross-cloud price, ``c_cross·mult[t % len]``."""
        mults = self.price_multipliers
        return float(np.float32(self.c_cross)
                     * np.float32(mults[t % len(mults)]))

    def topology(self) -> CloudTopology:
        return CloudTopology(cloud_of=np.array(self.cloud_of),
                             n_clouds=self.n_clouds,
                             aggregator_cloud=self.aggregator_cloud)


def hooks_of(scenario: Optional[Scenario]) -> JitHooks:
    if scenario is None or scenario.jit_hooks is None:
        return JitHooks()
    return scenario.jit_hooks


def supports(flcfg: FLConfig, method: str,
             scenario: Optional[Scenario] = None) -> bool:
    """Can the round engine run this (config, method, scenario)? Not a
    scenario with host hooks and no ``jit_hooks``, nor dropout under an
    order-statistic aggregator (it would read the zeroed rows as
    clients): those run in the host round loop."""
    if method not in METHODS or flcfg.attack not in UPDATE_ATTACKS:
        return False
    if scenario is not None and not scenario.jittable:
        return False
    if hooks_of(scenario).p_drop > 0 and method not in MASKED_DELIVERY_OK:
        return False
    return True


def resolve_engine(engine: str, flcfg: FLConfig, topo: CloudTopology,
                   method: str, scenario: Optional[Scenario] = None, *,
                   n_devices: Optional[int] = None) -> str:
    """Route a (config, method, scenario) onto a round loop, as the
    reference routes: ``"shard"`` (the mesh-sharded engine,
    ``federated.sharded``), ``"jit"`` (the round engine) or ``"host"``
    (the host round loop). ``n_devices``: the ranks of the process group
    (default: the default group's size, 1 when none is initialized).

    ``"auto"`` takes the sharded engine only with more than one rank, a
    dense round (2·clients_per_round ≥ N) and a combination it supports;
    then the round engine where :func:`supports` says so, else the host
    loop. ``"shard"`` or ``"jit"`` on a combination they cannot run
    raises ``ValueError`` with the reason."""
    from repro_torch.federated import sharded as sharded_mod
    if n_devices is None:
        n_devices = sharded_mod.group_size()
    if engine == "host":
        return "host"
    if engine == "shard":
        reason = sharded_mod.shard_unsupported_reason(
            flcfg, topo, method, scenario, n_devices=n_devices)
        if reason is not None:
            raise ValueError(f"engine='shard' but {reason}")
        return "shard"
    if engine == "jit":
        if not supports(flcfg, method, scenario):
            raise ValueError(
                f"engine='jit' but method={method!r} / "
                f"scenario={getattr(scenario, 'name', None)!r} "
                "is not jittable")
        return "jit"
    if engine != "auto":
        raise ValueError(f"unknown engine {engine!r}; expected "
                         "'auto' | 'shard' | 'jit' | 'host'")
    # the sharded engine trains every client (masked), so "auto" prefers
    # it only where few of the trained rows are masked away
    dense = 2 * flcfg.clients_per_round >= topo.n_clients
    if (n_devices > 1 and dense and sharded_mod.shard_unsupported_reason(
            flcfg, topo, method, scenario, n_devices=n_devices) is None):
        return "shard"
    return "jit" if supports(flcfg, method, scenario) else "host"


def static_from(flcfg: FLConfig, topo: CloudTopology,
                method: str = "cost_trustfl",
                scenario: Optional[Scenario] = None,
                input_shape: Tuple[int, ...] = (32, 32, 3),
                n_classes: int = 10) -> EngineStatic:
    """Freeze (FLConfig, topology, scenario). Raises ``ValueError`` for
    what the engine cannot run (see :func:`supports`; route with
    :func:`resolve_engine` first)."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; known: {METHODS}")
    if flcfg.attack not in UPDATE_ATTACKS:
        raise ValueError(f"unknown attack {flcfg.attack!r}; known: "
                         f"{sorted(UPDATE_ATTACKS)}")
    if flcfg.trust_features not in ("scalar", "multi"):
        raise ValueError(f"unknown trust_features {flcfg.trust_features!r}; "
                         "use 'scalar' or 'multi'")
    if not supports(flcfg, method, scenario):
        raise ValueError(
            f"the round engine cannot run method={method!r} "
            f"scenario={getattr(scenario, 'name', None)!r} (host hooks "
            "without jit_hooks, or dropout under an order-statistic "
            "aggregator): use the host round loop, engine='host'")
    h = hooks_of(scenario)
    # resolves (and validates) the compressor and link policy
    build_link_policy(flcfg.compressor, ratio=flcfg.compress_ratio,
                      levels=flcfg.qsgd_levels, link_policy=flcfg.link_policy)
    return EngineStatic(
        method=method, cloud_of=tuple(int(c) for c in topo.cloud_of),
        n_clouds=topo.n_clouds, aggregator_cloud=topo.aggregator_cloud,
        input_shape=tuple(input_shape), n_classes=int(n_classes),
        clients_per_round=flcfg.clients_per_round,
        cost_lambda=flcfg.cost_lambda, c_intra=flcfg.c_intra,
        c_cross=flcfg.c_cross, attack=flcfg.attack,
        attack_scale=flcfg.attack_scale, gaussian_sigma=flcfg.gaussian_sigma,
        attack_z=flcfg.attack_z, local_epochs=flcfg.local_epochs,
        local_batch=flcfg.local_batch, lr=flcfg.lr,
        server_lr=flcfg.server_lr, ema_gamma=flcfg.ema_gamma,
        malicious_frac=flcfg.malicious_frac, compressor=flcfg.compressor,
        compress_ratio=flcfg.compress_ratio, qsgd_levels=flcfg.qsgd_levels,
        link_policy=flcfg.link_policy, p_drop=float(h.p_drop),
        malice_warmup=int(h.malice_warmup),
        price_multipliers=tuple(float(m) for m in h.price_multipliers),
        trust_features=flcfg.trust_features)


# ---------------------------------------------------------------------------
# flat-vector plumbing (the reference's ravel_pytree layout: sorted keys,
# each leaf row-major in JAX layout)

def tree_l2(params: Dict[str, Tensor]) -> Tensor:
    """() float32 L2 norm over every leaf of ``params`` — the state
    digest of each round (the reference's ``tree_l2``), two reductions
    on the params' device: the leaves' norms, then the norm of those."""
    return torch.linalg.vector_norm(torch.stack(
        torch._foreach_norm([params[k] for k in sorted(params)])))


def ravel_rows(tree: Dict[str, Tensor]) -> Tensor:
    """Flatten a dict of (B, ...) leaves into (B, D), sorted-key order."""
    b = next(iter(tree.values())).shape[0]
    return torch.cat([tree[k].reshape(b, -1) for k in sorted(tree)], dim=1)


def unflatten_like(vec: Tensor, template: Dict[str, Tensor]
                   ) -> Dict[str, Tensor]:
    """Inverse of a single-row :func:`ravel_rows`."""
    out, off = {}, 0
    for k in sorted(template):
        n = template[k].numel()
        out[k] = vec[off:off + n].reshape(template[k].shape)
        off += n
    return out


def last_layer_index(shapes: Dict[str, Tuple[int, ...]]) -> np.ndarray:
    """Positions of :data:`LAST_LAYER` (weight, then bias) in the
    flattened vector."""
    offsets, off = {}, 0
    for k in sorted(shapes):
        offsets[k] = off
        off += int(np.prod(shapes[k]))
    return np.concatenate([
        np.arange(offsets[k], offsets[k] + int(np.prod(shapes[k])))
        for k in LAST_LAYER])


def last_layer_range(shapes: Dict[str, Tuple[int, ...]]) -> Tuple[int, int]:
    """(lo, L): the contiguous column range [lo, lo + L) that holds the
    positions of :data:`LAST_LAYER` (for the paper's CNN [D − 1290, D):
    ``fc2_b`` then ``fc2_w``). The trust stage reads it in place; its
    sums do not depend on the columns' order. Raises ``ValueError`` when
    the positions are not one contiguous range."""
    idx = np.sort(last_layer_index(shapes))
    lo = int(idx[0])
    if not np.array_equal(idx, np.arange(lo, lo + len(idx))):
        raise ValueError(f"the trust path's leaves {LAST_LAYER} are not "
                         "one contiguous range of the flattened vector")
    return lo, len(idx)


def _stream(seed: int, t: int, *folds: int, device: torch.device
            ) -> torch.Generator:
    """The own-mode stream of round t under the fold path ``folds``."""
    h = seed * 7919 + t
    for f in folds:
        h = h * 1_000_003 + f
    g = torch.Generator(device=device)
    g.manual_seed(h % (2 ** 63))
    return g


# ---------------------------------------------------------------------------
# host-side helpers shared with the server

def draw_malicious(flcfg: FLConfig, n_clients: int, seed: int) -> np.ndarray:
    """The static adversary draw (the reference's, bit for bit)."""
    rng = np.random.default_rng(seed)
    n_mal = int(flcfg.malicious_frac * n_clients)
    mal = np.zeros(n_clients, bool)
    mal[rng.choice(n_clients, n_mal, replace=False)] = True
    return mal


def poison_labels(flcfg: FLConfig, data: FederatedData,
                  malicious: np.ndarray, seed: int) -> np.ndarray:
    """label_flip poisoning (identity for other attacks)."""
    y = np.array(data.client_y)
    if flcfg.attack != "label_flip":
        return y
    rng = np.random.default_rng(seed + 1)
    nc = data.n_classes
    for i in np.nonzero(malicious)[0]:
        y[i] = (y[i] + rng.integers(1, nc, size=y[i].shape)) % nc
    return y


def make_client_data(flcfg: FLConfig, topo: CloudTopology,
                     data: FederatedData, seed: int, *,
                     device: torch.device,
                     malicious: Optional[np.ndarray] = None,
                     poisoned_y: Optional[np.ndarray] = None) -> ClientData:
    """Stage one seed's round-invariant inputs on ``device``."""
    if malicious is None:
        malicious = draw_malicious(flcfg, topo.n_clients, seed)
    if poisoned_y is None:
        poisoned_y = poison_labels(flcfg, data, malicious, seed)

    def dev(a, dtype=None):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return ClientData(client_x=dev(data.client_x),
                      client_y=dev(poisoned_y, torch.int64),
                      ref_x=dev(data.ref_x),
                      ref_y=dev(data.ref_y, torch.int64),
                      malicious=dev(malicious, torch.bool))


def host_round_accounting(static: EngineStatic, d_params: int,
                          client_payload: np.ndarray,
                          edge_payload: np.ndarray,
                          delivered_rounds: np.ndarray,
                          t0: int = 0) -> np.ndarray:
    """Byte-exact float64 (cost, intra_bytes, cross_bytes) rows for a
    (T, N) stack of delivered masks of rounds t0, t0 + 1, ..., each billed
    at its round's ``c_cross`` multiplier."""
    st = static
    topo = st.topology()
    mults = st.price_multipliers
    rows = np.empty((len(delivered_rounds), 3), np.float64)
    for i, dmask in enumerate(np.asarray(delivered_rounds, bool)):
        cm = CostModel(st.c_intra,
                       st.c_cross * mults[(t0 + i) % len(mults)])
        intra_b, cross_b = cm.round_bytes(
            topo, dmask, d_params, hierarchical=st.hierarchical,
            client_payload=client_payload, edge_payload=edge_payload)
        cost = cm.round_cost(
            topo, dmask, d_params, hierarchical=st.hierarchical,
            client_payload=client_payload, edge_payload=edge_payload)
        rows[i] = (cost, intra_b, cross_b)
    return rows


# ---------------------------------------------------------------------------
# the engine

class Engine:
    """The round step for one :class:`EngineStatic` on one device."""

    def __init__(self, static: EngineStatic, device: torch.device):
        st = self.static = static
        self.device = dev = torch.device(device)
        topo = st.topology()
        self.n, self.k = topo.n_clients, topo.n_clouds
        self.agg = topo.aggregator_cloud
        self.hier = hier = st.hierarchical
        self.cloud_of_np = np.array(st.cloud_of)
        self.cloud_of = torch.as_tensor(self.cloud_of_np, device=dev)
        self.cloud_sizes = np.bincount(self.cloud_of_np, minlength=self.k)

        h, w, c = st.input_shape
        flat = (h // 4) * (w // 4) * 64
        self.shapes = {
            "conv1_b": (32,), "conv1_w": (3, 3, c, 32),
            "conv2_b": (64,), "conv2_w": (3, 3, 32, 64),
            "fc1_b": (128,), "fc1_w": (flat, 128),
            "fc2_b": (st.n_classes,), "fc2_w": (128, st.n_classes)}
        self.d_params = int(sum(np.prod(s) for s in self.shapes.values()))
        self.ll_lo, self.ll_len = last_layer_range(self.shapes)

        self.link_policy = lp = build_link_policy(
            st.compressor, ratio=st.compress_ratio, levels=st.qsgd_levels,
            link_policy=st.link_policy)
        self.client_payload, self.edge_payload = lp.payload_vectors(
            topo, self.d_params, hierarchical=hier)
        # hierarchical: every client→edge hop is intra-class, and the
        # cloud aggregates cross the edge wire; flat: a client's one hop
        # is intra or cross by co-location, and there is no edge wire
        self.client_wire_active = ((not lp.intra.is_identity) if hier
                                   else lp.any_active)
        self.edge_wire_active = hier and lp.any_active
        self.client_wire_noise = (lp.intra.needs_noise if hier else
                                  lp.intra.needs_noise or lp.cross.needs_noise)
        self.edge_wire_noise = self.edge_wire_active and (
            lp.intra.needs_noise or lp.cross.needs_noise)
        # the flat client wire's codec sub-fold of each client: 0 (intra)
        # in the aggregator's cloud, 1 (cross) elsewhere
        self.client_sub = np.where(self.cloud_of_np == self.agg, 0, 1)
        # the one stochastic codec of the edge wire reads the reference's
        # codec sub-fold: 3 (cross) when cross-cloud links quantize, else
        # 2 (intra, ``intra_only``)
        self.edge_noise_fold = 3 if lp.cross.needs_noise else 2
        self.cp = torch.as_tensor(self.client_payload, dtype=torch.float32,
                                  device=dev)
        self.ep = torch.as_tensor(self.edge_payload, dtype=torch.float32,
                                  device=dev)
        self.quota = exploration_quota(st.cost_lambda) if hier else 0
        self.m_total = selected_count(self.n, st.clients_per_round,
                                      self.quota, self.cloud_of_np)

    # -- state and randomness ------------------------------------------------
    def init_params(self, seed: int) -> Dict[str, Tensor]:
        """The CNN's own init from ``seed`` on this device (sorted keys)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        params = client_mod.cnn_init(gen, self.static.input_shape,
                                     self.static.n_classes,
                                     device=self.device)
        return {k: params[k] for k in sorted(params)}

    def init_state(self, seed: int,
                   params: Optional[Dict[str, Tensor]] = None,
                   client_rows: Optional[int] = None) -> RoundState:
        """Round-zero state: ``params`` (default: :meth:`init_params`),
        uniform reputation, zero residuals on the lossy wires (the client
        wire's for ``client_rows`` clients, default all N), zero feature
        separability under ``multi``."""
        dev = self.device
        if params is None:
            params = self.init_params(seed)
        if client_rows is None:
            client_rows = self.n
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        empty = torch.zeros(0, device=dev)
        return RoundState(
            params={k: params[k] for k in sorted(params)},
            rep_ema=ReputationState.init(self.n, device=dev).ema,
            res_client=(torch.zeros(client_rows, self.d_params, device=dev)
                        if self.client_wire_active else empty),
            res_edge=(torch.zeros(self.k, self.d_params, device=dev)
                      if self.edge_wire_active else empty),
            cum_cost=zero, cum_intra_bytes=zero, cum_cross_bytes=zero,
            feat_sep=(torch.zeros(feats_mod.N_FEATURES, device=dev)
                      if self.static.multi_features else empty),
            seed=int(seed))

    def schedule(self, data: ClientData) -> Tuple[int, int]:
        """(client steps, reference steps) of one round's LocalTrain."""
        st = self.static
        return (client_mod.steps_for(data.client_x.shape[1],
                                     st.local_epochs, st.local_batch),
                client_mod.steps_for(data.ref_x.shape[1], st.local_epochs,
                                     REF_BATCH))

    def _noise_rows(self, seed: int, t: int, paths) -> Tensor:
        """(len(paths), D) U[0, 1) wire noise, row i from the own-mode
        stream of round t under the fold path ``paths[i]``."""
        dev = self.device
        out = torch.empty(len(paths), self.d_params, device=dev)
        for row, folds in enumerate(paths):
            torch.rand(self.d_params, device=dev, out=out[row],
                       generator=_stream(seed, t, *folds, device=dev))
        return out

    def client_noise(self, seed: int, t: int, senders) -> Tensor:
        """(len(senders), D) client-wire noise, row i from the stream of
        client ``senders[i]``: (211, client) on the hierarchical path,
        (211, sub-fold, client) on the flat one (sub-fold 0 in the
        aggregator's cloud, 1 elsewhere, as the reference folds 0 into
        its intra pass and 1 into its cross pass)."""
        ids = [int(i) for i in senders]
        if self.hier:
            return self._noise_rows(seed, t, [(_FOLD_CLIENT_WIRE, i)
                                              for i in ids])
        return self._noise_rows(seed, t, [
            (_FOLD_CLIENT_WIRE, int(self.client_sub[i]), i) for i in ids])

    def edge_noise(self, seed: int, t: int) -> Tensor:
        return self._noise_rows(seed, t, [
            (_FOLD_EDGE_WIRE, self.edge_noise_fold, c) for c in range(self.k)])

    def draws(self, seed: int, t: int, data: ClientData,
              full_noise: bool = False) -> RoundDraws:
        """Own-mode round randomness from device ``torch.Generator``s.
        The wire noise is drawn in :meth:`step` for the selected senders
        only; ``full_noise=True`` materializes it for every client and
        cloud now (the same streams, so the round is the same) — for
        running one set of draws on two devices."""
        dev = self.device
        st = self.static
        steps, ref_steps = self.schedule(data)
        sel_gen = _stream(seed, t, _FOLD_SELECT, device=dev)
        return RoundDraws(
            select_noise=(torch.randn(self.n, device=dev, generator=sel_gen)
                          if self.hier else None),
            client_idx=torch.randint(
                0, data.client_x.shape[1],
                (self.n, steps, st.local_batch), device=dev,
                generator=_stream(seed, t, _FOLD_TRAIN, device=dev)),
            ref_idx=torch.randint(
                0, data.ref_x.shape[1], (ref_steps, REF_BATCH), device=dev,
                generator=_stream(seed, t, _FOLD_REF, device=dev)),
            client_noise=(self.client_noise(seed, t, range(self.n))
                          if full_noise and self.client_wire_noise
                          else None),
            edge_noise=(self.edge_noise(seed, t)
                        if full_noise and self.edge_wire_noise else None),
            perm=(None if self.hier else
                  torch.randperm(self.n, device=dev, generator=sel_gen)),
            drop_u=(torch.rand(self.n, device=dev, generator=_stream(
                seed, t, _FOLD_DROPOUT, device=dev))
                    if st.p_drop > 0 else None))

    def attack_noise(self, seed: int, t: int, m: int) -> Tensor:
        """(m, D) standard normals of the gaussian attack."""
        return torch.randn(m, self.d_params, device=self.device,
                           generator=_stream(seed, t, _FOLD_ATTACK,
                                             device=self.device))

    # -- selection and delivery ----------------------------------------------
    def select(self, rep_ema: Tensor, c_cross_t: float,
               draws: RoundDraws) -> Tensor:
        """(N,) bool selected set: Eq. 10 with the per-cloud quota and the
        tie-break noise (hierarchical), or ``perm[:m]`` (flat)."""
        st = self.static
        if self.hier:
            unit_costs = hierarchical_unit_costs_torch(
                self.cloud_of, self.cloud_sizes, self.agg, st.c_intra,
                c_cross_t)
            return select_clients(rep_ema, unit_costs, st.clients_per_round,
                                  st.cost_lambda, per_cloud_min=self.quota,
                                  cloud_of=self.cloud_of_np,
                                  noise=draws.select_noise)
        if draws.perm is None:
            raise ValueError("the flat selection needs draws.perm")
        sel = torch.zeros(self.n, dtype=torch.bool, device=self.device)
        sel[draws.perm[:self.m_total].long()] = True
        return sel

    def deliver(self, sel: Tensor, draws: RoundDraws) -> Tensor:
        """(N,) bool delivered mask: ``sel`` without the dropped clients
        (each dropped when its uniform is below ``p_drop``); when that
        leaves nobody, the first selected client delivers."""
        p_drop = self.static.p_drop
        if p_drop <= 0.0:
            return sel
        if draws.drop_u is None:
            raise ValueError("dropout needs draws.drop_u")
        out = sel & (draws.drop_u >= p_drop)
        need = sel.any() & ~out.any()
        first = torch.arange(self.n, device=self.device) == torch.argmax(
            sel.to(torch.int32))
        return out | (need & first & sel)

    # -- the wires -----------------------------------------------------------
    def client_wire(self, flat_sel: Tensor, res_client: Tensor,
                    sel_idx: Tensor, valid: Tensor,
                    noise: Optional[Tensor]) -> Tensor:
        """Round-trip the selected rows through their uplink codec with
        error feedback (the selected senders' rows of ``res_client`` are
        updated in place); rows that did not deliver pass through and
        keep their residual. ``noise``: the senders' (m, D) QSGD rows
        where the wire reads noise (:meth:`client_noise`). Hierarchical:
        every hop takes the intra codec. Flat: the intra codec on the
        aggregator's cloud, the cross codec elsewhere; under ``all`` (one
        codec object) that is one round trip over every delivered row
        (one launch), each row's QSGD noise from its own sub-fold."""
        lp = self.link_policy
        cur = res_client[sel_idx]
        if self.hier or lp.intra is lp.cross:
            flat_sel, cur = ef_step_masked(lp.intra, flat_sel, cur, valid,
                                           noise)
        else:
            same = self.cloud_of[sel_idx] == self.agg
            for codec, mask in ((lp.intra, valid & same),
                                (lp.cross, valid & ~same)):
                flat_sel, cur = ef_step_masked(codec, flat_sel, cur, mask,
                                               noise)
        res_client.index_copy_(0, sel_idx, cur)
        return flat_sel

    def edge_wire(self, cloud_aggs: Tensor, res_edge: Tensor,
                  active: Tensor, noise: Optional[Tensor]
                  ) -> Tuple[Tensor, Tensor]:
        """Round-trip the (K, D) cloud aggregates through each cloud's
        uplink codec with error feedback: the aggregator's own row takes
        the intra codec, the others the cross codec; when both are one
        codec (``all``) that is one round trip over all K rows (one
        launch). Inactive clouds pass through and keep their residual."""
        lp = self.link_policy
        y = cloud_aggs + res_edge
        if lp.intra is lp.cross:
            x_hat, res = lp.cross.roundtrip_residual(y, noise)
        else:
            is_agg = (torch.arange(self.k, device=self.device)
                      == self.agg)[:, None]
            x_hat = torch.where(is_agg, lp.intra.roundtrip(y, noise),
                                lp.cross.roundtrip(y, noise))
            res = y - x_hat
        return (torch.where(active, x_hat, cloud_aggs),
                torch.where(active, res, res_edge))

    # -- one round ---------------------------------------------------------------
    def step(self, state: RoundState, data: ClientData, t: int,
             draws: Optional[RoundDraws] = None
             ) -> Tuple[RoundState, RoundOut]:
        """One round. Its phases run under the reference's profiler labels
        (``record_function``: ``round.select``, ``round.train``,
        ``round.attack``, ``round.compress`` where the client wire is
        lossy, ``round.aggregate``, ``round.account``); ``round.train``
        also holds the cloud references' LocalTrain, which the reference
        runs under ``round.aggregate``."""
        st, dev = self.static, self.device
        with record_function("round.select"):
            if draws is None:
                draws = self.draws(state.seed, t, data)
            draws = RoundDraws(*(None if d is None
                                 else torch.as_tensor(d, device=dev)
                                 for d in draws))
            c_cross_t = st.c_cross_at(t)
            # selection, then delivery (dropped clients train too — fixed
            # shapes — but are masked below)
            sel = self.select(state.rep_ema, c_cross_t, draws)
            delivered = self.deliver(sel, draws)
            sel_idx = torch.nonzero(sel).reshape(-1)             # ascending
            valid = delivered[sel_idx]

        # local training of the selected clients and, where the method
        # reads them, the cloud references
        with record_function("round.train"):
            upd = client_mod.local_train(
                state.params, data.client_x[sel_idx], data.client_y[sel_idx],
                draws.client_idx[sel_idx].long(), lr=st.lr)
            flat_sel = ravel_rows(upd)                            # (m, D)
            ref_flat = None
            if self.hier or st.method == "fltrust":
                ref_idx = draws.ref_idx.long()[None].expand(self.k, -1, -1)
                ref_flat = ravel_rows(client_mod.local_train(
                    state.params, data.ref_x, data.ref_y, ref_idx,
                    lr=st.lr))

        # update-level attack on this round's ACTIVE malicious rows
        with record_function("round.attack"):
            if UPDATE_ATTACKS[st.attack] is not None:
                mal = data.malicious
                if t < st.malice_warmup:
                    mal = torch.zeros_like(mal)
                noise = draws.attack_noise
                if st.attack in NOISY_ATTACKS and noise is None:
                    noise = self.attack_noise(state.seed, t,
                                              flat_sel.shape[0])
                flat_sel = apply_update_attack(
                    st.attack, flat_sel, mal[sel_idx] & valid, noise,
                    sigma=st.gaussian_sigma, scale=st.attack_scale,
                    z=st.attack_z, valid=valid if st.p_drop > 0 else None)

        res_client = state.res_client
        if self.client_wire_active:
            with record_function("round.compress"):
                noise = None
                if self.client_wire_noise:
                    noise = (draws.client_noise[sel_idx]
                             if draws.client_noise is not None
                             else self.client_noise(state.seed, t,
                                                    sel_idx.tolist()))
                flat_sel = self.client_wire(flat_sel, res_client, sel_idx,
                                            valid, noise)
        with record_function("round.aggregate"):
            # what did not deliver aggregates as a zero row
            if st.p_drop > 0:
                flat_sel = torch.where(valid[:, None], flat_sel, 0.0)
            if self.hier:
                update, new_rep, res_edge, new_feat_sep, feat_w = (
                    self._hierarchical_update(state, flat_sel, ref_flat,
                                              sel_idx, valid, draws, t))
            else:
                update = self._flat_update(flat_sel, valid, ref_flat)
                new_rep, res_edge = state.rep_ema, state.res_edge
                new_feat_sep = state.feat_sep
                feat_w = torch.zeros(0, device=dev)
            # w <- w - eta * g
            delta = unflatten_like(update * st.server_lr, state.params)
            params = {kk: state.params[kk] - delta[kk]
                      for kk in state.params}

        with record_function("round.account"):
            # float32 wire accounting mirror (FLServer bills float64 on
            # host) and the state digest
            intra_b, cross_b = round_bytes_torch(delivered, self.cloud_of,
                                                 self.agg, self.cp, self.ep,
                                                 hierarchical=self.hier)
            cost = (intra_b * st.c_intra + cross_b * c_cross_t) / _GB
            digest = tree_l2(params)
        new_state = RoundState(
            params=params, rep_ema=new_rep, res_client=res_client,
            res_edge=res_edge, cum_cost=state.cum_cost + cost,
            cum_intra_bytes=state.cum_intra_bytes + intra_b,
            cum_cross_bytes=state.cum_cross_bytes + cross_b,
            feat_sep=new_feat_sep, seed=state.seed)
        out = RoundOut(delivered=delivered, rep=new_rep, cost=cost,
                       intra_bytes=intra_b, cross_bytes=cross_b,
                       params_l2=digest, feat_weights=feat_w)
        return new_state, out

    def run(self, state: RoundState, data: ClientData, rounds: int,
            tap: Optional[TapSpec] = None) -> Tuple[RoundState, RoundOut]:
        """``rounds`` rounds of :meth:`step` from ``state`` in own mode:
        the final state and the rounds' ``RoundOut`` with every field
        stacked (T, ...) on the device. With an enabled ``tap``
        (``telemetry.taps``), each round's outputs go to the installed
        collector as numpy as the round ends; untapped, the run adds no
        device read of its own."""
        step = taps_mod.instrument(self.step, tap)
        outs = []
        for t in range(rounds):
            state, out = step(state, data, t)
            outs.append(out)
        if not outs:
            raise ValueError("Engine.run needs rounds >= 1")
        return state, RoundOut(*(torch.stack(xs) for xs in zip(*outs)))

    def _hierarchical_update(self, state: RoundState, flat_sel: Tensor,
                             ref_flat: Tensor, sel_idx: Tensor,
                             valid: Tensor, draws: RoundDraws, t: int):
        """Cost-TrustFL's Eq. 5–13 on the wire view: (update, new_rep,
        res_edge, new_feat_sep, feat_w)."""
        st, dev = self.static, self.device
        k = self.k
        # the trust stage reads the attacked + compressed wire view in
        # place (the last layer's columns), in one kernel launch: Eq. 7
        # with the median damp, under "multi" the feature gate (the
        # separability EMA updated first, the gate with THIS round's
        # weights), Eq. 8–9 normalize + EMA for delivered rows, and Eq. 11
        # trust against the client's own-cloud reference
        sel_cloud = self.cloud_of[sel_idx]                        # (m,)
        w = valid.to(torch.float32)
        stage = ops.trust_stage(
            flat_sel, ref_flat, self.ll_lo, self.ll_len, sel_cloud, w,
            state.rep_ema, sel_idx, st.ema_gamma, self.n,
            feat_sep=state.feat_sep if st.multi_features else None, eps=EPS)
        new_rep = state.rep_ema.clone()
        new_rep[sel_idx] = stage.rep_sel
        ts = stage.ts
        new_feat_sep = state.feat_sep
        feat_w = torch.zeros(0, device=dev)
        if st.multi_features:
            new_feat_sep, feat_w = stage.new_sep, stage.feat_w

        # Eq. 12 rescale to the own-cloud reference norm (full rows) +
        # Eq. 13 per-cloud aggregate in one kernel pass
        cloud_aggs = ops.weighted_agg(
            flat_sel, ts, torch.linalg.vector_norm(flat_sel, dim=1),
            torch.linalg.vector_norm(ref_flat, dim=1), seg=sel_cloud,
            n_seg=k, eps=EPS)
        ts_cloud = torch.zeros(k, device=dev).index_add_(0, sel_cloud, ts)
        res_edge = state.res_edge
        if self.edge_wire_active:
            active = (torch.zeros(k, device=dev).index_add_(0, sel_cloud, w)
                      > 0)[:, None]
            noise = None
            if self.edge_wire_noise:
                noise = (draws.edge_noise if draws.edge_noise is not None
                         else self.edge_noise(state.seed, t))
            cloud_aggs, res_edge = self.edge_wire(cloud_aggs, res_edge,
                                                  active, noise)
        # empty/zero-trust clouds fall back to their reference
        cloud_aggs = torch.where((ts_cloud > EPS)[:, None], cloud_aggs,
                                 ref_flat)

        # Eq. 6 cross-cloud combine
        beta = cloud_trust(cloud_aggs, torch.mean(ref_flat, dim=0))
        return beta @ cloud_aggs, new_rep, res_edge, new_feat_sep, feat_w

    def _flat_update(self, u: Tensor, valid: Tensor,
                     ref_flat: Optional[Tensor]) -> Tensor:
        """The baseline's (D,) aggregate of the (m, D) wire view."""
        st = self.static
        if st.method == "fedavg":
            if st.p_drop > 0:
                w = valid.to(u.dtype)
                return (w @ u) / torch.clamp(torch.sum(w), min=1.0)
            return robust.fedavg(u)
        if st.method == "krum":
            f_mal = int(st.malicious_frac * self.m_total)
            return robust.krum(u, f_mal,
                               multi=max(1, self.m_total - f_mal - 2))
        if st.method == "trimmed_mean":
            return robust.trimmed_mean(u, trim_frac=st.malicious_frac / 2)
        if st.method == "median":
            return robust.coordinate_median(u)
        # fltrust: zero (dropped) rows get TS = 0, so masked delivery is safe
        return robust.fltrust(u, torch.mean(ref_flat, dim=0))

    def host_round_accounting(self, delivered_rounds: np.ndarray,
                              t0: int = 0) -> np.ndarray:
        """See :func:`host_round_accounting`."""
        return host_round_accounting(self.static, self.d_params,
                                     self.client_payload, self.edge_payload,
                                     delivered_rounds, t0=t0)
