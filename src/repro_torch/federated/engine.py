"""The Cost-TrustFL round as ``Engine.step(state, data, t) -> (state,
out)``: the port of the hierarchical branch of the reference's
``round_step`` (``repro/federated/engine.py``).

One round: Eq. 10 selection (per-cloud quota + tie-break noise), local
training of the selected clients and of the per-cloud references,
Eq. 7 contribution with the median damp, Eq. 8–9 reputation EMA, Eq. 11
trust against the client's own-cloud reference, Eq. 12 rescale + Eq. 13
per-cloud aggregate, the edge→global wire (top-k with error feedback),
the Eq. 6 β combine, and byte-exact accounting. Eq. 7 + 11 statistics go
through the ``trust_score`` kernel, Eq. 12 + 13 through ``weighted_agg``
and the wire's sparsification through ``topk_mask``.

Round randomness is a :class:`RoundDraws`: the selection noise and the
minibatch indices of the clients and of the reference training. Own mode
(:meth:`Engine.draws`) draws them from ``torch.Generator`` streams on the
device seeded from ``(seed·7919 + t, fold)``; replay mode takes them
from the caller, e.g. re-derived from the reference's key schedule.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.compress import build_link_policy
from repro_torch.configs.base import FLConfig
from repro_torch.core.cost import (CostModel, hierarchical_unit_costs_torch,
                                   round_bytes_torch)
from repro_torch.core.fl_types import CloudTopology
from repro_torch.core.reputation import ReputationState
from repro_torch.core.selection import exploration_quota, select_clients
from repro_torch.core.trust import cloud_trust
from repro_torch.data.pipeline import FederatedData
from repro_torch.federated import client as client_mod
from repro_torch.kernels import ops

Tensor = torch.Tensor

_GB = 1024.0 ** 3
REF_BATCH = 32          # reference LocalTrain batch (client default)
EPS = 1e-12

# own-mode stream tags (selection keeps the reference's fold number)
_FOLD_SELECT = 131
_FOLD_TRAIN = 1
_FOLD_REF = 2

# the trust path's g^(L): the final dense layer, weight then bias (the
# reference's last two template leaves by insertion order)
LAST_LAYER = ("fc2_w", "fc2_b")

# attacks that leave the update matrix untouched (label_flip poisons data)
_PORTED_ATTACKS = ("none", "label_flip")


class RoundState(NamedTuple):
    """Everything a round mutates."""
    params: Dict[str, Tensor]    # model parameters (JAX layout, sorted keys)
    rep_ema: Tensor              # (N,) Eq. 9 reputation EMA
    res_edge: Tensor             # (K, D) EF residuals, edge uplinks ((0,) when inactive)
    cum_cost: Tensor             # () running $ (float32; hosts reduce f64)
    cum_intra_bytes: Tensor      # () running intra-class wire bytes
    cum_cross_bytes: Tensor      # () running cross-cloud wire bytes
    seed: int                    # own-mode stream root


class RoundOut(NamedTuple):
    """Per-round metrics."""
    delivered: Tensor            # (N,) bool — selected AND delivered
    rep: Tensor                  # (N,) post-update reputation EMA
    cost: Tensor                 # () $ this round (float32 mirror)
    intra_bytes: Tensor          # () wire bytes, intra-class
    cross_bytes: Tensor          # () wire bytes, cross-cloud


class ClientData(NamedTuple):
    """Round-invariant device inputs."""
    client_x: Tensor             # (N, S, H, W, C)
    client_y: Tensor             # (N, S) int64 labels (already poisoned)
    ref_x: Tensor                # (K, R, H, W, C) per-cloud reference sets
    ref_y: Tensor                # (K, R)
    malicious: Tensor            # (N,) bool static adversary set


class RoundDraws(NamedTuple):
    """One round's randomness."""
    select_noise: Tensor         # (N,) standard normals (Eq. 10 tie-break)
    client_idx: Tensor           # (N, steps, batch) minibatch indices
    ref_idx: Tensor              # (ref_steps, REF_BATCH), shared by clouds


@dataclass(frozen=True)
class EngineStatic:
    """The engine-relevant slice of (FLConfig, topology)."""
    cloud_of: Tuple[int, ...]
    n_clouds: int
    aggregator_cloud: int
    input_shape: Tuple[int, ...]
    n_classes: int
    clients_per_round: int
    cost_lambda: float
    c_intra: float
    c_cross: float
    local_epochs: int
    local_batch: int
    lr: float
    server_lr: float
    ema_gamma: float
    compressor: str
    compress_ratio: float
    qsgd_levels: int
    link_policy: str

    def topology(self) -> CloudTopology:
        return CloudTopology(cloud_of=np.array(self.cloud_of),
                             n_clouds=self.n_clouds,
                             aggregator_cloud=self.aggregator_cloud)


def static_from(flcfg: FLConfig, topo: CloudTopology,
                method: str = "cost_trustfl",
                input_shape: Tuple[int, ...] = (32, 32, 3),
                n_classes: int = 10) -> EngineStatic:
    """Freeze (FLConfig, topology); configurations outside this slice of
    the port raise ``NotImplementedError`` naming the slice they wait for
    (ROADMAP queue A)."""
    if method != "cost_trustfl":
        raise NotImplementedError(
            f"method={method!r} is not ported yet: the baselines come with "
            "ROADMAP queue A item 5")
    if flcfg.attack not in _PORTED_ATTACKS:
        raise NotImplementedError(
            f"attack={flcfg.attack!r} is not ported yet: update-level "
            "attacks come with ROADMAP queue A item 5")
    if flcfg.trust_features == "multi":
        raise NotImplementedError(
            "trust_features='multi' is not ported yet: it comes with the "
            "trust_features kernel (ROADMAP queue A item 7)")
    if flcfg.trust_features != "scalar":
        raise ValueError(f"unknown trust_features {flcfg.trust_features!r}; "
                         "use 'scalar' or 'multi'")
    lp = build_link_policy(flcfg.compressor, ratio=flcfg.compress_ratio,
                           levels=flcfg.qsgd_levels,
                           link_policy=flcfg.link_policy)
    if not lp.intra.is_identity:
        raise NotImplementedError(
            f"link_policy={flcfg.link_policy!r} compresses client uplinks, "
            "which is not ported yet (ROADMAP queue A item 6)")
    return EngineStatic(
        cloud_of=tuple(int(c) for c in topo.cloud_of),
        n_clouds=topo.n_clouds, aggregator_cloud=topo.aggregator_cloud,
        input_shape=tuple(input_shape), n_classes=int(n_classes),
        clients_per_round=flcfg.clients_per_round,
        cost_lambda=flcfg.cost_lambda, c_intra=flcfg.c_intra,
        c_cross=flcfg.c_cross, local_epochs=flcfg.local_epochs,
        local_batch=flcfg.local_batch, lr=flcfg.lr,
        server_lr=flcfg.server_lr, ema_gamma=flcfg.ema_gamma,
        compressor=flcfg.compressor, compress_ratio=flcfg.compress_ratio,
        qsgd_levels=flcfg.qsgd_levels, link_policy=flcfg.link_policy)


# ---------------------------------------------------------------------------
# flat-vector plumbing (the reference's ravel_pytree layout: sorted keys,
# each leaf row-major in JAX layout)

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


def _stream(seed: int, t: int, fold: int, device: torch.device
            ) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(((seed * 7919 + t) * 1_000_003 + fold) % (2 ** 63))
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
                          delivered_rounds: np.ndarray) -> np.ndarray:
    """Byte-exact float64 (cost, intra_bytes, cross_bytes) rows for a
    (T, N) stack of delivered masks."""
    topo = static.topology()
    cm = CostModel(static.c_intra, static.c_cross)
    rows = np.empty((len(delivered_rounds), 3), np.float64)
    for i, dmask in enumerate(np.asarray(delivered_rounds, bool)):
        intra_b, cross_b = cm.round_bytes(
            topo, dmask, d_params, hierarchical=True,
            client_payload=client_payload, edge_payload=edge_payload)
        cost = cm.round_cost(
            topo, dmask, d_params, hierarchical=True,
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
        self.ll_idx = torch.as_tensor(last_layer_index(self.shapes),
                                      device=dev)

        self.link_policy = lp = build_link_policy(
            st.compressor, ratio=st.compress_ratio, levels=st.qsgd_levels,
            link_policy=st.link_policy)
        self.client_payload, self.edge_payload = lp.payload_vectors(
            topo, self.d_params, hierarchical=True)
        self.edge_wire_active = lp.any_active
        self.cp = torch.as_tensor(self.client_payload, dtype=torch.float32,
                                  device=dev)
        self.ep = torch.as_tensor(self.edge_payload, dtype=torch.float32,
                                  device=dev)
        self.quota = exploration_quota(st.cost_lambda)

    # -- state and randomness ------------------------------------------------
    def init_state(self, seed: int,
                   params: Optional[Dict[str, Tensor]] = None) -> RoundState:
        """Round-zero state: ``params`` (default: own init from ``seed``),
        uniform reputation, zero edge residuals when the wire is lossy."""
        dev = self.device
        if params is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            params = client_mod.cnn_init(gen, self.static.input_shape,
                                         self.static.n_classes, device=dev)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        return RoundState(
            params={k: params[k] for k in sorted(params)},
            rep_ema=ReputationState.init(self.n, device=dev).ema,
            res_edge=(torch.zeros(self.k, self.d_params, device=dev)
                      if self.edge_wire_active
                      else torch.zeros(0, device=dev)),
            cum_cost=zero, cum_intra_bytes=zero, cum_cross_bytes=zero,
            seed=int(seed))

    def schedule(self, data: ClientData) -> Tuple[int, int]:
        """(client steps, reference steps) of one round's LocalTrain."""
        st = self.static
        return (client_mod.steps_for(data.client_x.shape[1],
                                     st.local_epochs, st.local_batch),
                client_mod.steps_for(data.ref_x.shape[1], st.local_epochs,
                                     REF_BATCH))

    def draws(self, seed: int, t: int, data: ClientData) -> RoundDraws:
        """Own-mode round randomness from device ``torch.Generator``s."""
        dev = self.device
        steps, ref_steps = self.schedule(data)
        return RoundDraws(
            select_noise=torch.randn(self.n, device=dev,
                                     generator=_stream(seed, t, _FOLD_SELECT,
                                                       dev)),
            client_idx=torch.randint(
                0, data.client_x.shape[1],
                (self.n, steps, self.static.local_batch), device=dev,
                generator=_stream(seed, t, _FOLD_TRAIN, dev)),
            ref_idx=torch.randint(
                0, data.ref_x.shape[1], (ref_steps, REF_BATCH), device=dev,
                generator=_stream(seed, t, _FOLD_REF, dev)))

    # -- the edge→global wire ------------------------------------------------
    def edge_wire(self, cloud_aggs: Tensor, res_edge: Tensor,
                  active: Tensor) -> Tuple[Tensor, Tensor]:
        """Round-trip the (K, D) cloud aggregates through each cloud's
        uplink codec with error feedback: the cross codec runs on all K
        rows (one launch), then the aggregator's own row takes the intra
        codec. Inactive clouds pass through and keep their residual."""
        lp = self.link_policy
        is_agg = (torch.arange(self.k, device=self.device)
                  == self.agg)[:, None]
        y = cloud_aggs + res_edge
        hat_cross = lp.cross.roundtrip(y)
        hat_intra = (hat_cross if lp.intra is lp.cross
                     else lp.intra.roundtrip(y))
        x_hat = torch.where(is_agg, hat_intra, hat_cross)
        return (torch.where(active, x_hat, cloud_aggs),
                torch.where(active, y - x_hat, res_edge))

    # -- one round ---------------------------------------------------------------
    def step(self, state: RoundState, data: ClientData, t: int,
             draws: Optional[RoundDraws] = None
             ) -> Tuple[RoundState, RoundOut]:
        st, dev = self.static, self.device
        if draws is None:
            draws = self.draws(state.seed, t, data)
        draws = RoundDraws(*(torch.as_tensor(d, device=dev) for d in draws))
        n, k = self.n, self.k

        # Eq. 10 selection (every selected client delivers in this slice)
        unit_costs = hierarchical_unit_costs_torch(
            self.cloud_of, self.cloud_sizes, self.agg, st.c_intra, st.c_cross)
        sel = select_clients(state.rep_ema, unit_costs, st.clients_per_round,
                             st.cost_lambda, per_cloud_min=self.quota,
                             cloud_of=self.cloud_of_np,
                             noise=draws.select_noise)
        delivered = sel
        sel_idx = torch.nonzero(sel).reshape(-1)                 # ascending
        valid = delivered[sel_idx]

        # local training of the selected clients and the cloud references
        upd = client_mod.local_train(
            state.params, data.client_x[sel_idx], data.client_y[sel_idx],
            draws.client_idx[sel_idx].long(), lr=st.lr)
        flat_sel = ravel_rows(upd)                                # (m, D)
        ref_idx = draws.ref_idx.long()[None].expand(k, -1, -1)
        ref_flat = ravel_rows(client_mod.local_train(
            state.params, data.ref_x, data.ref_y, ref_idx, lr=st.lr))
        ll_sel = flat_sel[:, self.ll_idx]                         # (m, L)
        ref_ll = ref_flat[:, self.ll_idx]                         # (K, L)
        sel_cloud = self.cloud_of[sel_idx]                        # (m,)
        w = valid.to(torch.float32)

        # Eq. 7 + 11 statistics in one kernel pass: phi, ReLU(cos(g, own
        # cloud ref)) (reputation 1 — Eq. 11 needs the POST-EMA rep), ‖g‖
        gbar = (w @ ll_sel) / torch.clamp(torch.sum(w), min=1.0)
        phi, cos_ref, norms = ops.trust_score(
            ll_sel, gbar, ref_ll, torch.ones_like(w), ref_idx=sel_cloud)
        # median damp (jnp.nanmedian averages the middle pair; so does
        # the 0.5 quantile, unlike torch.nanmedian)
        med = torch.nanquantile(
            torch.where(w > 0, norms, torch.full_like(norms, float("nan"))),
            0.5)
        damp = torch.clamp((med / torch.clamp(norms, min=EPS)) ** 2, max=1.0)
        damp = torch.where(torch.isnan(damp), torch.ones_like(damp), damp)
        phi = phi * damp * w

        # Eq. 8–9: normalize over the round, EMA for delivered rows
        total = torch.sum(phi)
        r = torch.where(total > EPS, phi / torch.clamp(total, min=EPS),
                        torch.full_like(phi, 1.0 / n))
        rep_old = state.rep_ema[sel_idx]
        rep_sel = st.ema_gamma * rep_old + (1.0 - st.ema_gamma) * r
        rep_sel = torch.where(valid, rep_sel, rep_old)
        new_rep = state.rep_ema.clone()
        new_rep[sel_idx] = rep_sel

        # Eq. 11 trust, then Eq. 12 rescale to the own-cloud reference
        # norm (full rows) + Eq. 13 per-cloud aggregate in one kernel pass
        ts = cos_ref * rep_sel * w
        cloud_aggs = ops.weighted_agg(
            flat_sel, ts, torch.linalg.vector_norm(flat_sel, dim=1),
            torch.linalg.vector_norm(ref_flat, dim=1), seg=sel_cloud,
            n_seg=k, eps=EPS)
        ts_cloud = torch.zeros(k, device=dev).index_add_(0, sel_cloud, ts)
        res_edge = state.res_edge
        if self.edge_wire_active:
            active = (torch.zeros(k, device=dev).index_add_(0, sel_cloud, w)
                      > 0)[:, None]
            cloud_aggs, res_edge = self.edge_wire(cloud_aggs, res_edge,
                                                  active)
        # empty/zero-trust clouds fall back to their reference
        cloud_aggs = torch.where((ts_cloud > EPS)[:, None], cloud_aggs,
                                 ref_flat)

        # Eq. 6 cross-cloud combine, then w <- w - eta * g
        beta = cloud_trust(cloud_aggs, torch.mean(ref_flat, dim=0))
        update = beta @ cloud_aggs
        delta = unflatten_like(update * st.server_lr, state.params)
        params = {kk: state.params[kk] - delta[kk] for kk in state.params}

        # float32 wire accounting mirror (FLServer bills float64 on host)
        intra_b, cross_b = round_bytes_torch(delivered, self.cloud_of,
                                             self.agg, self.cp, self.ep)
        cost = (intra_b * st.c_intra + cross_b * st.c_cross) / _GB
        new_state = RoundState(
            params=params, rep_ema=new_rep, res_edge=res_edge,
            cum_cost=state.cum_cost + cost,
            cum_intra_bytes=state.cum_intra_bytes + intra_b,
            cum_cross_bytes=state.cum_cross_bytes + cross_b,
            seed=state.seed)
        out = RoundOut(delivered=delivered, rep=new_rep, cost=cost,
                       intra_bytes=intra_b, cross_bytes=cross_b)
        return new_state, out

    def host_round_accounting(self, delivered_rounds: np.ndarray
                              ) -> np.ndarray:
        """See :func:`host_round_accounting`."""
        return host_round_accounting(self.static, self.d_params,
                                     self.client_payload, self.edge_payload,
                                     delivered_rounds)
