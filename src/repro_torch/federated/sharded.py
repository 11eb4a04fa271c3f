"""The mesh-sharded round engine on ``torch.distributed`` (the port of
``repro/federated/sharded.py``): the client population laid out over a
``(cloud, client)`` mesh of ranks, with Eq. 5–13's hierarchical
aggregation as a two-stage reduction — an all-reduce over the ``client``
group (the ranks of one mesh column, which own whole clouds: intra-cloud
traffic), then one over the ``cloud`` group (the per-cloud egress hop).

A rank is one device: one card, or one process on the CPU. The mesh is
``mesh_axes``' factorization kc × pc of the group's size, and rank r =
cloud_idx·pc + client_idx owns the contiguous client block
[r·n_loc, (r + 1)·n_loc). Three kinds of group carry the collectives:
the world (the engine's group: the caller's, or the default one), the
``client`` groups (one per mesh column) and the ``cloud`` groups (one per
client index). At world size 1 every collective is still issued. Per
round each rank

* evaluates Eq. 10 selection and delivery REPLICATED on the full (N,)
  reputation, through the round engine's own ``Engine.select`` /
  ``Engine.deliver`` on the same ``RoundDraws`` (drawn alike on every
  rank);
* trains ALL of its local clients (masked local training: the selected
  subset has no fixed per-rank size) and masks the other rows out of
  every statistic — so the engine suits dense participation, and
  ``resolve_engine("auto")`` prefers it only there;
* applies the update attack (the honest-statistics adversaries read
  masked global reductions over the rows the round engine sees) and its
  client wire, with error-feedback residuals for its own rows only;
* runs the trust path over its rows with ḡ and the median norm reduced
  across ranks first: one standalone ``trust_score`` launch (Eq. 7 + 11
  statistics) and, under ``trust_features="multi"``, one standalone
  ``trust_features`` launch, the (6, F) separability sums in one world
  all-reduce; Eq. 12–13 as one segmented ``weighted_agg_rows`` launch
  whose (K, D) partial sums are all-reduced before the division;
* accounts bytes and $ from the replicated delivered mask with the round
  engine's ``round_bytes_torch``.

Support surface (:func:`shard_unsupported_reason`, in the reference's
words): every method runs, but ``gaussian`` (an (m, D) noise tensor) and
``min_max`` (bisection on the selected matrix's Gram) are tied to the
selected matrix's layout and refused; so are host-hook scenarios,
dropout under an order statistic, uneven client→cloud maps and
populations that do not tile the ranks. Krum, the trimmed mean and the
median rebuild the (m, D) selected matrix in the round engine's row
order with a slot scatter and one world all-reduce.

Parity: at world size 1 the engine matches the round engine's
``Engine.step`` on the same draws — masks, bytes and $ exactly,
reputation and params within 1e-4 (partial sums associate differently).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from repro_torch.compress import ef_step_masked
from repro_torch.configs.base import FLConfig
from repro_torch.core import features as feats_mod
from repro_torch.core import robust
from repro_torch.core.cost import round_bytes_torch
from repro_torch.core.fl_types import CloudTopology
from repro_torch.core.trust import cloud_trust
from repro_torch.data.pipeline import FederatedData
from repro_torch.federated import client as client_mod
from repro_torch.federated import engine as engine_mod
from repro_torch.federated.engine import (EPS, MASKED_DELIVERY_OK, METHODS,
                                          ClientData, Engine, EngineStatic,
                                          RoundDraws, RoundOut, RoundState,
                                          hooks_of, ravel_rows, tree_l2,
                                          unflatten_like)
from repro_torch.kernels import ops
from repro_torch.scenarios.base import Scenario

Tensor = torch.Tensor

_GB = 1024.0 ** 3

# attacks whose per-round transform decomposes over client shards: per
# row (sign_flip, scaling, the data-level label_flip) or driven by masked
# GLOBAL moments (alie, alie_norm, ipm, collusion); ``gaussian`` and
# ``min_max`` are matrix-shaped
SHARD_ATTACKS = ("none", "label_flip", "sign_flip", "scaling", "alie",
                 "alie_norm", "ipm", "collusion")

# top-k is per-row deterministic and QSGD's noise is keyed per sender
SHARD_COMPRESSORS = ("none", "topk", "qsgd")


# ---------------------------------------------------------------------------
# the group and the mesh

def group_size() -> int:
    """Ranks of the default group; 1 when none is initialized (the
    one-rank group ``FLServer`` and ``run_simulation_sharded`` would
    start)."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size()


def ensure_group(device: torch.device) -> bool:
    """Start a one-rank default group when none is initialized: NCCL for
    the card's tensors (and gloo for the CPU's) where CUDA is present,
    gloo alone otherwise. Returns whether it started one (the caller then
    ends it with ``dist.destroy_process_group()``)."""
    if dist.is_initialized():
        return False
    backend = ("cpu:gloo,cuda:nccl" if torch.device(device).type == "cuda"
               else "gloo")
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)
    return True


def mesh_axes(n_clouds: int, n_clients: int,
              n_devices: Optional[int] = None) -> Optional[Tuple[int, int]]:
    """``(cloud, client)`` axis sizes of ``n_devices`` ranks (default: the
    group's size): the cloud axis takes the largest common divisor, so
    mesh columns own whole clouds; ``None`` when the population does not
    tile the ranks."""
    if n_devices is None:
        n_devices = group_size()
    if n_devices < 1 or n_clients % n_devices != 0:
        return None
    kc = math.gcd(n_devices, n_clouds)
    return kc, n_devices // kc


def _even_contiguous(topo: CloudTopology) -> bool:
    """Cloud k owns clients [k·n_k, (k+1)·n_k) (``CloudTopology.even``)."""
    n, k = topo.n_clients, topo.n_clouds
    if n % k != 0:
        return False
    return bool(np.array_equal(topo.cloud_of, np.arange(n) // (n // k)))


def shard_unsupported_reason(flcfg: FLConfig, topo: CloudTopology,
                             method: str,
                             scenario: Optional[Scenario] = None, *,
                             n_devices: Optional[int] = None
                             ) -> Optional[str]:
    """``None`` when the sharded engine can run this combination, else
    the reason (the reference's words; raised verbatim)."""
    if method not in METHODS:
        return f"unknown method {method!r}"
    if scenario is not None and not scenario.jittable:
        return (f"scenario {scenario.name!r} has host-only hooks "
                "(no JitHooks declaration)")
    if hooks_of(scenario).p_drop > 0 and method not in MASKED_DELIVERY_OK:
        return (f"dropout with order-statistic aggregator {method!r} "
                "(zero rows would count as clients)")
    if flcfg.attack not in SHARD_ATTACKS:
        return (f"attack {flcfg.attack!r} is matrix-shaped (randomness or "
                "statistics tied to the selected matrix's layout) — use "
                "the scan engine")
    if flcfg.compressor not in SHARD_COMPRESSORS:
        return (f"compressor {flcfg.compressor!r} is not "
                "shard-decomposable — use the scan engine")
    if not _even_contiguous(topo):
        return ("client→cloud layout is not the even contiguous "
                "CloudTopology.even map")
    if n_devices is None:
        n_devices = group_size()
    if mesh_axes(topo.n_clouds, topo.n_clients, n_devices) is None:
        return (f"{topo.n_clients} clients do not tile "
                f"{n_devices} devices")
    return None


def supports_shard(flcfg: FLConfig, method: str,
                   scenario: Optional[Scenario] = None, *,
                   topo: Optional[CloudTopology] = None,
                   n_devices: Optional[int] = None) -> bool:
    if topo is None:
        topo = CloudTopology.even(flcfg.n_clouds, flcfg.clients_per_cloud)
    return shard_unsupported_reason(flcfg, topo, method, scenario,
                                    n_devices=n_devices) is None


@dataclass(frozen=True)
class ShardStatic:
    """The round engine's static slice plus the mesh factorization."""
    static: EngineStatic
    kc: int
    pc: int


def static_from_shard(flcfg: FLConfig, topo: CloudTopology, method: str,
                      scenario: Optional[Scenario] = None,
                      input_shape: Tuple[int, ...] = (32, 32, 3),
                      n_classes: int = 10, *,
                      n_devices: Optional[int] = None) -> ShardStatic:
    reason = shard_unsupported_reason(flcfg, topo, method, scenario,
                                      n_devices=n_devices)
    if reason is not None:
        raise ValueError(f"sharded engine cannot run this config: {reason}")
    kc, pc = mesh_axes(topo.n_clouds, topo.n_clients, n_devices)
    st = engine_mod.static_from(flcfg, topo, method, scenario,
                                input_shape=input_shape, n_classes=n_classes)
    return ShardStatic(static=st, kc=kc, pc=pc)


# ---------------------------------------------------------------------------
# the engine

class ShardEngine:
    """One rank's round step for one :class:`ShardStatic`, on ``device``,
    over ``group`` (default: the default group, which must be
    initialized; its size must be kc·pc). Duck-types :class:`Engine`'s
    round-loop surface (``step``, ``run``, ``init_state``,
    ``host_round_accounting`` and the attributes ``FLServer`` and the
    telemetry read). Every rank of ``group`` builds its engine, in any
    order: the mesh groups are created with local synchronization."""

    def __init__(self, shard_static: ShardStatic, device: torch.device,
                 group: Optional[dist.ProcessGroup] = None):
        self.shard_static = ss = shard_static
        self.static = st = ss.static
        self.eng = eng = Engine(st, device)
        self.device = dev = eng.device
        self.group = group
        ranks = (dist.get_process_group_ranks(group) if group is not None
                 else list(range(dist.get_world_size())))
        n_ranks = len(ranks)
        if n_ranks != ss.kc * ss.pc:
            raise ValueError(f"the group has {n_ranks} ranks; the mesh "
                             f"{ss.kc} x {ss.pc} needs {ss.kc * ss.pc}")
        self.rank = rank = dist.get_rank(group)
        self.cloud_idx, self.client_idx = divmod(rank, ss.pc)
        backend = None if group is None else dist.get_backend(group)
        # my mesh column (the ranks of my cloud index), then my row
        self.client_group = dist.new_group(
            [ranks[self.cloud_idx * ss.pc + j] for j in range(ss.pc)],
            backend=backend, use_local_synchronization=True)
        self.cloud_group = dist.new_group(
            [ranks[c * ss.pc + self.client_idx] for c in range(ss.kc)],
            backend=backend, use_local_synchronization=True)

        self.n, self.k = eng.n, eng.k
        self.n_loc = self.n // n_ranks
        self.i0 = rank * self.n_loc
        self.rows = slice(self.i0, self.i0 + self.n_loc)
        self.gids = np.arange(self.i0, self.i0 + self.n_loc)  # global ids
        n_k = self.n // self.k                   # even contiguous layout
        self.cloud_loc = torch.as_tensor(self.gids // n_k, device=dev)
        self.same_loc = self.cloud_loc == eng.agg
        # what FLServer and the telemetry read of an engine
        self.hier = eng.hier
        self.d_params = eng.d_params
        self.m_total = eng.m_total
        self.client_payload = eng.client_payload
        self.edge_payload = eng.edge_payload

    # -- collectives -------------------------------------------------------------
    def _psum(self, x: Tensor) -> Tensor:
        """World all-reduce (sum) of a fresh tensor, in place."""
        dist.all_reduce(x, group=self.group)
        return x

    def _psum_scalar(self, x: Tensor) -> Tensor:
        """World sum of the 0-d ``x``, 0-d."""
        return self._psum(x.reshape(1))[0]

    def _gather(self, x_loc: Tensor) -> Tensor:
        """(N, ...) from each rank's (n_loc, ...) rows, in rank order: a
        zero-filled buffer holding this rank's rows, all-reduced (exact:
        every other rank adds zeros)."""
        buf = torch.zeros((self.n,) + tuple(x_loc.shape[1:]),
                          dtype=x_loc.dtype, device=x_loc.device)
        buf[self.rows] = x_loc
        return self._psum(buf)

    def _masked_moments(self, x: Tensor, w: Tensor
                        ) -> Tuple[Tensor, Tensor]:
        """Global per-coordinate (mean, std) over the rows weighted by
        ``w`` (sums for the mean, then centered squares)."""
        n = torch.clamp(self._psum_scalar(torch.sum(w)), min=1.0)
        mean = self._psum(w @ x) / n
        var = self._psum(torch.sum(((x - mean) ** 2) * w[:, None],
                                   dim=0)) / n
        return mean, torch.sqrt(torch.clamp(var, min=EPS * EPS))

    def _attack(self, flat: Tensor, mal: Tensor, honest_w: Tensor
                ) -> Tensor:
        """The update attack over the local rows: ``mal`` the round's
        ACTIVE malicious delivered rows, ``honest_w`` the delivered honest
        rows (the set the round engine's honest moments read)."""
        st = self.static
        name, scale = st.attack, st.attack_scale
        if name in ("none", "label_flip"):
            return flat
        rm = mal[:, None]
        if name == "sign_flip":
            return torch.where(rm, -scale * flat, flat)
        if name == "scaling":
            return torch.where(rm, scale * flat, flat)
        if name == "alie":
            mean, std = self._masked_moments(flat, honest_w)
            return torch.where(rm, mean - st.attack_z * std, flat)
        if name == "alie_norm":
            mean, std = self._masked_moments(flat, honest_w)
            point = mean - st.attack_z * std
            # the honest median norm (the middle pair's mean) over the
            # gathered (N,) norms, NaN outside the honest delivered rows
            norms = torch.linalg.vector_norm(flat, dim=1)
            all_hn = self._gather(torch.where(
                honest_w > 0, norms, torch.full_like(norms, float("nan"))))
            med = torch.nanquantile(all_hn, 0.5)
            med = torch.where(torch.isnan(med) | ~(med > 0),
                              torch.ones_like(med), med)
            point = point * (med / torch.clamp(
                torch.linalg.vector_norm(point), min=EPS))
            return torch.where(rm, point, flat)
        if name == "ipm":
            mean, _ = self._masked_moments(flat, honest_w)
            return torch.where(rm, -scale * mean, flat)
        if name == "collusion":
            w = mal.to(flat.dtype)
            n_m = torch.clamp(self._psum_scalar(torch.sum(w)), min=1.0)
            return torch.where(rm, -scale * (self._psum(w @ flat) / n_m),
                               flat)
        raise ValueError(f"attack {name!r} is not shard-decomposable")

    # -- state and data ----------------------------------------------------------
    def init_state(self, seed: int) -> RoundState:
        """The round engine's round-zero state, the client residuals for
        this rank's rows only."""
        return self.eng.init_state(seed, client_rows=self.n_loc)

    def stage_data(self, data: ClientData) -> ClientData:
        """This rank's client block of the full ``data``; the references
        replicated."""
        r = self.rows
        return ClientData(client_x=data.client_x[r].clone(),
                          client_y=data.client_y[r].clone(),
                          ref_x=data.ref_x, ref_y=data.ref_y,
                          malicious=data.malicious[r].clone())

    # -- one round ---------------------------------------------------------------
    def step(self, state: RoundState, data: ClientData, t: int,
             draws: Optional[RoundDraws] = None
             ) -> Tuple[RoundState, RoundOut]:
        """One round on this rank's client block ``data`` (from
        :meth:`stage_data`); ``draws`` are the full fleet's (replay mode),
        or the round engine's own-mode draws, made alike on every rank.
        Phases under the round engine's ``round.*`` labels."""
        st, eng, dev = self.static, self.eng, self.device
        rows = self.rows
        with record_function("round.select"):
            if draws is None:
                draws = eng.draws(state.seed, t, data)
            cn = draws.client_noise
            draws = RoundDraws(*(None if d is None
                                 else torch.as_tensor(d, device=dev)
                                 for d in draws._replace(client_noise=None)))
            c_cross_t = st.c_cross_at(t)
            sel = eng.select(state.rep_ema, c_cross_t, draws)
            delivered = eng.deliver(sel, draws)
            valid = delivered[rows]
            w = valid.to(torch.float32)

        # masked local training: every local client trains
        with record_function("round.train"):
            flat = ravel_rows(client_mod.local_train(
                state.params, data.client_x, data.client_y,
                draws.client_idx[rows].long(), lr=st.lr))       # (n_loc, D)
            ref_flat = None
            if self.hier or st.method == "fltrust":
                ref_idx = draws.ref_idx.long()[None].expand(self.k, -1, -1)
                ref_flat = ravel_rows(client_mod.local_train(
                    state.params, data.ref_x, data.ref_y, ref_idx,
                    lr=st.lr))

        # the update attack on this round's ACTIVE malicious rows
        with record_function("round.attack"):
            mal = data.malicious
            if t < st.malice_warmup:
                mal = torch.zeros_like(mal)
            flat = self._attack(flat, mal & valid,
                                ((~mal) & valid).to(torch.float32))

        # the client uplink wire; the residuals are this rank's rows
        res_client = state.res_client
        if eng.client_wire_active:
            with record_function("round.compress"):
                noise = None
                if eng.client_wire_noise:
                    noise = (torch.as_tensor(cn[rows], device=dev)
                             if cn is not None
                             else eng.client_noise(state.seed, t, self.gids))
                lp = eng.link_policy
                if self.hier or lp.intra is lp.cross:
                    flat, res_client = ef_step_masked(lp.intra, flat,
                                                      res_client, valid, noise)
                else:
                    for codec, mask in ((lp.intra, valid & self.same_loc),
                                        (lp.cross, valid & ~self.same_loc)):
                        flat, res_client = ef_step_masked(codec, flat,
                                                          res_client, mask,
                                                          noise)

        with record_function("round.aggregate"):
            # everything downstream reads the masked wire view
            flat = torch.where(w[:, None] > 0, flat, 0.0)
            if self.hier:
                update, new_rep, res_edge, new_feat_sep, feat_w = (
                    self._hierarchical_update(state, flat, ref_flat, valid,
                                              w, draws, t))
            else:
                update = self._flat_update(flat, w, sel, ref_flat)
                new_rep, res_edge = state.rep_ema, state.res_edge
                new_feat_sep = state.feat_sep
                feat_w = torch.zeros(0, device=dev)
            delta = unflatten_like(update * st.server_lr, state.params)
            params = {kk: state.params[kk] - delta[kk]
                      for kk in state.params}

        with record_function("round.account"):
            intra_b, cross_b = round_bytes_torch(delivered, eng.cloud_of,
                                                 eng.agg, eng.cp, eng.ep,
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

    def _hierarchical_update(self, state: RoundState, flat: Tensor,
                             ref_flat: Tensor, valid: Tensor, w: Tensor,
                             draws: RoundDraws, t: int):
        """Eq. 5–13 over this rank's rows of the wire view: (update,
        new_rep, res_edge, new_feat_sep, feat_w), all replicated."""
        st, eng, dev = self.static, self.eng, self.device
        k, lo, length = self.k, eng.ll_lo, eng.ll_len
        cloud = self.cloud_loc
        ll = flat[:, lo:lo + length].contiguous()              # (n_loc, L)
        ref_ll = ref_flat[:, lo:lo + length].contiguous()      # (K, L)

        # Eq. 7: gbar from one world all-reduce of the (L + 1) sums
        sums = self._psum(torch.cat([w @ ll, torch.sum(w).reshape(1)]))
        gbar = sums[:length] / torch.clamp(sums[length], min=1.0)
        # relu(cos(g, gbar))·‖g‖, relu(cos(g, own-cloud ref)), ‖g‖ in one
        # launch (reputation 1: Eq. 11 reads the post-EMA reputation)
        phi0, cos_ref, norms = ops.trust_score(
            ll, gbar, ref_ll, torch.ones_like(w), ref_idx=cloud, eps=EPS)
        # the median damp over the gathered delivered norms
        med = torch.nanquantile(self._gather(torch.where(
            w > 0, norms, torch.full_like(norms, float("nan")))), 0.5)
        damp = torch.clamp((med / torch.clamp(norms, min=EPS)) ** 2,
                           max=1.0)
        damp = torch.where(torch.isnan(damp), torch.ones_like(damp), damp)
        phi = phi0 * damp * w

        # the multi-feature gate: per-row features given gbar and med, the
        # separability sums in one (6, F) all-reduce, the EMA replicated
        new_feat_sep = state.feat_sep
        feat_w = torch.zeros(0, device=dev)
        if st.multi_features:
            feats = ops.trust_features(ll, ref_ll, gbar, med, w,
                                       ref_idx=cloud, eps=EPS)
            sep_round = feats_mod.separability_from_sums(
                self._psum(feats_mod.separability_sums(feats, w)), EPS)
            new_feat_sep = (feats_mod.FEAT_SEP_RHO * state.feat_sep
                            + (1.0 - feats_mod.FEAT_SEP_RHO) * sep_round)
            feat_w = feats_mod.feature_weights(new_feat_sep)
            phi = phi * feats_mod.gate(feats, new_feat_sep)

        # Eq. 8–9
        total = self._psum_scalar(torch.sum(phi))
        r = torch.where(total > EPS, phi / torch.clamp(total, min=EPS),
                        torch.full_like(phi, 1.0 / self.n))
        rep_loc = state.rep_ema[self.rows]
        rep_new_loc = st.ema_gamma * rep_loc + (1.0 - st.ema_gamma) * r
        rep_new_loc = torch.where(valid, rep_new_loc, rep_loc)
        new_rep = self._gather(rep_new_loc)

        # Eq. 11 trust, then Eq. 12 rescale + Eq. 13: this rank's (K, D)
        # partial sums in one segmented launch, all-reduced over the
        # client group (intra-cloud) and then the cloud group
        ts = cos_ref * rep_new_loc * w
        ref_norms = torch.linalg.vector_norm(ref_flat, dim=1)
        scale = ref_norms[cloud] / torch.clamp(
            torch.linalg.vector_norm(flat, dim=1), min=EPS)
        partial = ops.weighted_agg_rows(flat, ts * scale, cloud, k)
        dist.all_reduce(partial, group=self.client_group)        # stage 1
        dist.all_reduce(partial, group=self.cloud_group)         # stage 2
        per_cloud = self._psum(torch.cat([
            torch.zeros(k, device=dev).index_add_(0, cloud, ts),
            torch.zeros(k, device=dev).index_add_(0, cloud, w)]))
        ts_cloud, cnt_cloud = per_cloud[:k], per_cloud[k:]
        cloud_aggs = partial / torch.clamp(ts_cloud, min=EPS)[:, None]
        res_edge = state.res_edge
        if eng.edge_wire_active:
            noise = None
            if eng.edge_wire_noise:
                noise = (draws.edge_noise if draws.edge_noise is not None
                         else eng.edge_noise(state.seed, t))
            cloud_aggs, res_edge = eng.edge_wire(
                cloud_aggs, res_edge, (cnt_cloud > 0)[:, None], noise)
        # empty/zero-trust clouds fall back to their reference update
        cloud_aggs = torch.where((ts_cloud > EPS)[:, None], cloud_aggs,
                                 ref_flat)
        # Eq. 6 cross-cloud combine
        beta = cloud_trust(cloud_aggs, torch.mean(ref_flat, dim=0))
        return beta @ cloud_aggs, new_rep, res_edge, new_feat_sep, feat_w

    def _flat_update(self, flat: Tensor, w: Tensor, sel: Tensor,
                     ref_flat: Optional[Tensor]) -> Tensor:
        """The baseline's (D,) aggregate of the wire view's rows."""
        st = self.static
        if st.method == "fedavg":
            n = torch.clamp(self._psum_scalar(torch.sum(w)), min=1.0)
            return self._psum(w @ flat) / n
        if st.method == "fltrust":
            ref = torch.mean(ref_flat, dim=0)
            refn = torch.linalg.vector_norm(ref)
            norms = torch.linalg.vector_norm(flat, dim=1)
            cos = (flat @ ref) / torch.clamp(norms * refn, min=EPS)
            ts = torch.relu(cos) * w
            out = self._psum(ops.weighted_agg_rows(
                flat, ts * refn / torch.clamp(norms, min=EPS))[0])
            total = self._psum_scalar(torch.sum(ts))
            return out / torch.clamp(total, min=EPS)
        # the order statistics read the (m, D) selected matrix: each
        # selected row goes to its slot (its rank among the selected ids,
        # the round engine's row order), then one world all-reduce
        m = self.m_total
        slot = torch.clamp((torch.cumsum(sel.to(torch.int64), 0) - 1)
                           [self.rows], 0, m - 1)
        sel_loc = sel[self.rows]
        u = self._psum(torch.zeros(m, flat.shape[1], device=flat.device)
                       .index_add_(0, slot, torch.where(sel_loc[:, None],
                                                        flat, 0.0)))
        if st.method == "krum":
            f_mal = int(st.malicious_frac * m)
            return robust.krum(u, f_mal, multi=max(1, m - f_mal - 2))
        if st.method == "trimmed_mean":
            return robust.trimmed_mean(u, trim_frac=st.malicious_frac / 2)
        return robust.coordinate_median(u)

    def run(self, state: RoundState, data: ClientData, rounds: int
            ) -> Tuple[RoundState, RoundOut]:
        """``rounds`` rounds of :meth:`step` in own mode, the outputs
        stacked (T, ...) as :meth:`Engine.run` stacks them."""
        outs = []
        for t in range(rounds):
            state, out = self.step(state, data, t)
            outs.append(out)
        if not outs:
            raise ValueError("ShardEngine.run needs rounds >= 1")
        return state, RoundOut(*(torch.stack(xs) for xs in zip(*outs)))

    def host_round_accounting(self, delivered_rounds: np.ndarray,
                              t0: int = 0) -> np.ndarray:
        """See :func:`engine.host_round_accounting`."""
        return self.eng.host_round_accounting(delivered_rounds, t0=t0)


def engine_for(flcfg: FLConfig, topo: CloudTopology, data: FederatedData,
               method: str, scenario: Optional[Scenario] = None, *,
               device: torch.device,
               group: Optional[dist.ProcessGroup] = None,
               n_devices: Optional[int] = None) -> ShardEngine:
    """The :class:`ShardEngine` of (config, data shapes) over ``group``
    (default: the default group, which must be initialized).
    ``n_devices``, when given, must be the group's size."""
    size = dist.get_world_size(group)
    if n_devices is not None and n_devices != size:
        raise ValueError(f"n_devices={n_devices} but the process group has "
                         f"{size} ranks")
    ss = static_from_shard(flcfg, topo, method, scenario,
                           input_shape=tuple(data.client_x.shape[2:]),
                           n_classes=data.n_classes, n_devices=size)
    return ShardEngine(ss, device, group)


__all__ = ["SHARD_ATTACKS", "SHARD_COMPRESSORS", "ShardEngine",
           "ShardStatic", "engine_for", "ensure_group", "group_size",
           "mesh_axes", "shard_unsupported_reason", "static_from_shard",
           "supports_shard"]
