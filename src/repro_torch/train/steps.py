"""Train steps (the port's copy of ``repro/train/steps.py``): the paper's
Algorithm 1 as one federated train step of a language model, in the
reference's two strategies, and the plain one-device step.

The reference lays one client on each index of its mesh's data axes and
leaves the ``model`` axis to GSPMD. The port takes the same mesh as a
live ``DeviceMesh`` (``launch.mesh``): clients = the product of the data
axes, one a data index, clouds = the ``pod`` axis when there is one,
else contiguous client blocks (``MeshTopology.from_mesh``). The ranks
that share a ``model`` index hold every client between them; ranks along
``model`` repeat their data index's compute (these steps gather the
parameters whole; tensor-parallel compute over ``model`` runs in the
serve steps, ``models/parallel.py``) and, before the update, take the
gradient, reputation
and metrics of the model-index-0 rank, so their copies agree bit for
bit. Or it takes a ``ClientMesh(n_clients, group)``: the clients over
the ranks of a ``torch.distributed`` group, as ``federated/sharded.py``
lays out its round engine, rank r owning the contiguous client block
[r·n_loc, (r + 1)·n_loc). Either way the clients' ranks form the
``mesh_axes`` mesh, whose ``client`` groups (mesh columns, owning whole
clouds) carry the intra-cloud sums and whose ``cloud`` groups (mesh rows)
the cross-cloud ones. One rank may hold every client: that is the step
on one card. With no group initialized a ``ClientMesh`` step's first
call starts a one-rank group (``ensure_group``: gloo on the CPU,
``cpu:gloo,cuda:nccl`` on the card), which the step's ``close()`` ends.

* ``two_phase`` (paper-faithful): every client's full gradient, Eq. 7–13
  on the true last-layer gradients and full-gradient norms, the
  hierarchical Eq. 5–6 combine. A rank holds several clients, and a
  full-width gradient (recurrentgemma-2b in fp32: 10.78 GiB) leaves room
  for about one more beside the weights and AdamW's moments, so the step
  runs in two passes whose memory does not grow with the clients a rank
  holds. Pass A computes each local client's gradient, then each cloud's
  reference gradient (once a rank), keeping only its last layer, its
  full norm and its loss. The statistics follow on the kept values. Pass
  B recomputes each client whose aggregation weight is not 0 and adds
  weight·gradient into one accumulator (a cloud whose trust sums to 0
  adds its reference gradient instead), which is all-reduced before the
  optimizer's step. The price is a second backward per weighted client.
* ``fused`` (beyond-paper): per-client signatures (a Rademacher sketch Ω
  of the lm-head gradient) from one forward without gradients, the trust
  weights from them, then ONE backward of the trust-weighted loss over
  each rank's rows, all-reduced. Both batch forwards route MoE tokens
  over the whole global batch (``moe.route_over_ranks`` over the clients'
  ranks), as the reference's forward of the sharded batch does: the
  capacity, the kept tokens and the aux loss are the global batch's. A
  two-phase client's gradient routes over the client's rows, as in the
  reference's ``shard_map`` groups.

Both return ``(params, opt_state, rep, metrics)`` with the reference's
metric keys. Over a ``ClientMesh`` the optimizer updates ``params`` and
its state in place, whole on every rank. Over a ``DeviceMesh`` the step
stores them where the reference's ``in_shardings`` put them: parameters
as DTensors by ``param_specs`` (over the data axes too for the ``fsdp``
archs), AdamW's moments by ``opt_state_specs`` (ZeRO-1); whole tensors
given to it are cut to that placement on entry, and the step counter
stays whole. Each step gathers the parameters whole for the forwards and
backwards (the reference's ``P()`` in-spec); after the gradient's
all-reduce each rank updates only its slice of the moments and of the
parameters, which are then gathered back to their stored placement. The
update sees the gradient whole (a replicated DTensor), so a global-norm
clip reads all of it. Every rank is given the whole global batch
(client-major rows) and the reference batch and reads its own rows.
"""
from __future__ import annotations

import math
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.configs.base import FLConfig, ModelConfig
from repro_torch.core.selection import select_clients
from repro_torch.core.trust import tree_cos, tree_norm
from repro_torch.device import resolve_device
from repro_torch.federated.sharded import (ensure_group, group_ranks,
                                           mesh_axes, mesh_groups)
from repro_torch.models import transformer as tfm
from repro_torch.models.common import chunked_cross_entropy, softcap
from repro_torch.models.model import Model
from repro_torch.models.moe import route_over_ranks
from repro_torch.optim import OptState
from repro_torch.sharding import (axis_sizes, clients_group, full_tree,
                                  opt_state_specs, param_specs, shard_tree)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Tensor = torch.Tensor
EPS = 1e-12


# ---------------------------------------------------------------------------
# topology

@dataclass(frozen=True)
class ClientMesh:
    """The clients over the ranks of a group without a device mesh: the
    client count (what the reference reads off its mesh's data axes) and
    the group whose ranks hold the clients (``None``: the default group,
    started as a one-rank group if none is initialized)."""
    n_clients: int
    group: Optional[dist.ProcessGroup] = None


MeshLike = Union[ClientMesh, DeviceMesh]


@dataclass(frozen=True)
class MeshTopology:
    """Client/cloud layout derived from the mesh: clients = the data axes'
    shard groups; clouds = pods on a multi-pod mesh (``pod_aligned``),
    else contiguous groups of the clients."""
    daxes: Tuple[str, ...]
    n_clients: int
    n_clouds: int
    clients_per_cloud: int
    pod_aligned: bool

    @staticmethod
    def from_mesh(mesh, n_clouds: Optional[int] = None) -> "MeshTopology":
        """From a ``DeviceMesh``, a ``sharding.MeshShape`` or a
        ``ClientMesh`` (a single-pod mesh of ``n_clients`` data
        indices)."""
        sizes = ({"data": mesh.n_clients} if isinstance(mesh, ClientMesh)
                 else axis_sizes(mesh))
        daxes = tuple(a for a in ("pod", "data") if a in sizes)
        n_clients = math.prod(sizes[a] for a in daxes)
        if "pod" in sizes:
            k, pod_aligned = sizes["pod"], True
        else:
            k = n_clouds or min(4, n_clients)
            while n_clients % k:
                k -= 1
            pod_aligned = False
        return MeshTopology(daxes, n_clients, k, n_clients // k, pod_aligned)

    def cloud_of(self) -> np.ndarray:
        return np.arange(self.n_clients) // self.clients_per_cloud

    def unit_costs(self, c_intra: float, c_cross: float,
                   aggregator_cloud: int = 0) -> np.ndarray:
        """Marginal c_i (Eq. 10) under hierarchical aggregation: the intra
        upload to the edge plus the cloud's one cross upload amortized
        over its clients."""
        cloud = self.cloud_of()
        edge = np.where(cloud == aggregator_cloud, c_intra, c_cross)
        return c_intra + edge / max(self.clients_per_cloud, 1)


def _model_axis(mesh: DeviceMesh) -> Tuple[Optional[int], int]:
    """(the ``model`` dim of ``mesh``, or ``None``; this rank's index
    along it)."""
    names = list(mesh.mesh_dim_names)
    if "model" not in names:
        return None, 0
    m = names.index("model")
    return m, int(mesh.get_coordinate()[m])


def _mesh_cloud_groups(mesh: DeviceMesh, kc: int, pc: int
                       ) -> Tuple[dist.ProcessGroup, dist.ProcessGroup]:
    """This rank's intra- and cross-cloud groups over a mesh (as
    ``mesh_groups`` gives them over its clients' group): on a multi-pod
    mesh, a cloud a pod, its data and pod axes' own groups; else those of
    the mesh's ranks laid out as (cloud, client, model...)."""
    names = tuple(mesh.mesh_dim_names)
    if "pod" in names:
        return mesh.get_group("data"), mesh.get_group("pod")
    view = DeviceMesh(mesh.device_type,
                      mesh.mesh.reshape((kc, pc) + tuple(mesh.mesh.shape[1:])),
                      mesh_dim_names=("cloud", "client") + names[1:])
    return view.get_group("client"), view.get_group("cloud")


# each mesh's or group's intra- and cross-cloud groups by (kc, pc), keyed
# by the object's identity (two meshes of one layout compare equal, and one
# may outlive its process group), made once and dropped with it: every
# NCCL communicator holds buffers on the card, so the steps over one mesh
# or group share theirs
_CLOUD_GROUPS: Dict[int, dict] = {}


def _cloud_groups_of(owner: Any) -> dict:
    key = id(owner)
    if key not in _CLOUD_GROUPS:
        _CLOUD_GROUPS[key] = {}
        weakref.finalize(owner, _CLOUD_GROUPS.pop, key, None)
    return _CLOUD_GROUPS[key]


class _Ranks:
    """The step's place in its group, set up at its first call (the
    params' device picks the backend of a one-rank group it starts): its
    client block, the clouds its mesh column owns, the mesh groups; over
    a ``DeviceMesh``, also the group of its model-axis replicas."""

    def __init__(self, topo: MeshTopology, flcfg: FLConfig, mesh: MeshLike):
        self.topo, self.mesh = topo, mesh
        self.group = mesh.group if isinstance(mesh, ClientMesh) else None
        self.costs = topo.unit_costs(flcfg.c_intra, flcfg.c_cross)
        self.device: Optional[torch.device] = None
        self.started = False
        self.replicas: Optional[dist.ProcessGroup] = None

    def start(self, params) -> "_Ranks":
        dev = resolve_device(tree_leaves(params)[0].device)
        if self.device is not None:
            return self
        topo = self.topo
        if isinstance(self.mesh, ClientMesh):
            self.started = ensure_group(dev)
        else:
            self.group = clients_group(self.mesh)
            m, _ = _model_axis(self.mesh)
            if m is not None and self.mesh.shape[m] > 1:
                self.replicas = self.mesh.get_group("model")
                self.replica_src = dist.get_global_rank(self.replicas, 0)
        world = len(group_ranks(self.group))
        axes = mesh_axes(topo.n_clouds, topo.n_clients, world)
        if axes is None:
            self.close()
            raise ValueError(f"{topo.n_clients} clients do not tile "
                             f"{world} ranks")
        kc, pc = axes
        over_group = isinstance(self.mesh, ClientMesh)
        made = _cloud_groups_of(
            (self.group or dist.group.WORLD) if over_group else self.mesh)
        if (kc, pc) not in made:
            made[kc, pc] = (mesh_groups(self.group, kc, pc) if over_group
                            else _mesh_cloud_groups(self.mesh, kc, pc))
        self.client_group, self.cloud_group = made[kc, pc]
        rank = dist.get_rank(self.group)
        self.n_loc = topo.n_clients // world
        self.i0 = rank * self.n_loc
        self.clients = range(self.i0, self.i0 + self.n_loc)
        per_col = topo.n_clouds // kc
        self.clouds = range(rank // pc * per_col, (rank // pc + 1) * per_col)
        self.cloud_of = torch.as_tensor(topo.cloud_of(), device=dev)
        self.unit_costs = torch.as_tensor(self.costs, dtype=torch.float32,
                                          device=dev)
        self.device = dev
        return self

    def owner(self, cloud: int) -> bool:
        """Whether this rank holds ``cloud``'s first client (the one rank
        that adds the cloud's fallback reference gradient)."""
        return self.i0 <= cloud * self.topo.clients_per_cloud \
            < self.i0 + self.n_loc

    # -- collectives (in place, fp32 tensors) ------------------------------
    def intra_sum(self, x: Tensor) -> Tensor:
        """Sum over this rank's mesh column (its clouds' clients)."""
        dist.all_reduce(x, group=self.client_group)
        return x

    def cross_sum(self, x: Tensor) -> Tensor:
        """Sum over this rank's mesh row (one rank a column)."""
        dist.all_reduce(x, group=self.cloud_group)
        return x

    def all_sum(self, x: Tensor) -> Tensor:
        """Sum over every rank: intra-cloud, then cross-cloud."""
        return self.cross_sum(self.intra_sum(x))

    def gather(self, x_loc: Tensor) -> Tensor:
        """(N, ...) from each rank's (n_loc, ...) rows: a zero-filled
        buffer summed over every rank (exact: the others add zeros)."""
        buf = torch.zeros((self.topo.n_clients,) + tuple(x_loc.shape[1:]),
                          dtype=torch.float32, device=x_loc.device)
        buf[self.i0:self.i0 + self.n_loc] = x_loc
        return self.all_sum(buf)

    def agree(self, tensors: List[Tensor]) -> None:
        """Overwrite ``tensors`` with the model-index-0 replica's, in place
        (nothing without model-axis replicas): the replicas' results can
        differ in the last bits on the card (``index_add_`` in the MoE
        dispatch, each data group's own all-reduce), and each updates its
        own slice of parameters that are then gathered."""
        if self.replicas is None:
            return
        for x in tensors:
            dist.broadcast(x, src=self.replica_src, group=self.replicas)

    def close(self) -> None:
        """End the one-rank default group, and with it the mesh groups,
        when the first call started it (mesh groups made in a group the
        caller holds live as long as that group: torch.distributed does
        not reuse a destroyed group's name)."""
        if self.device is None and not self.started:
            return
        if self.started:
            dist.destroy_process_group()
        self.device, self.started = None, False


class _Whole:
    """A ``ClientMesh`` step's storage: parameters and optimizer state
    whole on every rank, updated in place."""

    def place(self, params, opt_state):
        return params, opt_state

    def gather(self, params):
        return params

    def update(self, opt_update, grads, opt_state, params):
        return opt_update(grads, opt_state, params)


class _BySpec:
    """A ``DeviceMesh`` step's storage: parameters by ``param_specs``,
    moments by ``opt_state_specs`` (ZeRO-1), as DTensors."""

    def __init__(self, model: Model, mesh: DeviceMesh):
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"a train step runs over a live DeviceMesh or "
                            f"a ClientMesh, not {type(mesh).__name__}")
        shapes = model.param_shapes()
        self.mesh = mesh
        self.pspecs = param_specs(shapes, model.cfg, mesh)
        self.mspecs = opt_state_specs(OptState(None, shapes, None), shapes,
                                      model.cfg, mesh).mu

    def _moments(self, tree):
        return None if tree is None else shard_tree(tree, self.mspecs,
                                                    self.mesh)

    def place(self, params, opt_state):
        step, mu, nu = opt_state
        return (shard_tree(params, self.pspecs, self.mesh),
                OptState(step, self._moments(mu), self._moments(nu)))

    def gather(self, params):
        return full_tree(params)

    def update(self, opt_update, grads, opt_state, params):
        """Each rank's slice: the gradient goes in whole (replicated; each
        op cuts it to the moments' slice locally), the parameters at the
        moments' placement; the result goes back to ``param_specs``'."""
        whole = [Replicate()] * self.mesh.ndim
        g = tree_map(lambda x: DTensor.from_local(x, self.mesh, whole,
                                                  run_check=False), grads)
        p = shard_tree(params, self.mspecs, self.mesh)
        p, opt_state = opt_update(g, opt_state, p)
        return shard_tree(p, self.pspecs, self.mesh), opt_state


def _storage(model: Model, mesh: MeshLike):
    return _Whole() if isinstance(mesh, ClientMesh) else _BySpec(model, mesh)


class FLTrainStep:
    """A federated train step: call it as the reference's step. ``close()``
    (or leaving a ``with`` block) ends the one-rank default group its
    first call started, if it started one."""

    def __init__(self, fn: Callable, ranks: _Ranks):
        self._fn, self._ranks = fn, ranks

    def __call__(self, *args, **kwargs):
        return self._fn(*args, **kwargs)

    def close(self) -> None:
        self._ranks.close()

    def __enter__(self) -> "FLTrainStep":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# shared scoring math

def _last_layer(grads: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The paper's g^(L): last FC (lm-head / tied embedding) + final norm."""
    out = {"final_norm": grads["final_norm"]}
    out["head"] = grads["lm_head"] if "lm_head" in grads else grads["embed"]
    return out


def _phi(ll: Dict[str, Tensor], ll_bar: Dict[str, Tensor],
         eps: float = EPS) -> Tensor:
    """Eq. 7 on trees."""
    return torch.relu(tree_cos(ll, ll_bar, eps)) * tree_norm(ll)


def _full_norm(tree: Any) -> Tensor:
    """‖tree‖ over every leaf in fp32 (nested trees)."""
    sq = sum(torch.sum(x.to(torch.float32) * x.to(torch.float32))
             for x in tree_leaves(tree))
    return torch.sqrt(torch.clamp(sq, min=0.0))


def _rows(batch: Dict[str, Tensor], lo: int, hi: int) -> Dict[str, Tensor]:
    """Rows [lo, hi) of every leaf (tokens, labels, mask, and a VLM's
    ``patches`` or an encoder-decoder's ``frames``)."""
    return {k: v[lo:hi] for k, v in batch.items()}


def _per_client(batch: Dict[str, Tensor], n: int) -> int:
    """Rows a client: the global batch's leading dim over the clients
    (every leaf must have it)."""
    rows = {k: v.shape[0] for k, v in batch.items()}
    b = rows["tokens"]
    if any(r != b for r in rows.values()):
        raise ValueError(f"the batch's leaves differ in rows: {rows}")
    if b % n:
        raise ValueError(f"a global batch of {b} rows does not split over "
                         f"{n} clients")
    return b // n


def _selection(ranks: _Ranks, flcfg: FLConfig, rep: Tensor
               ) -> Tuple[Tensor, Tensor, Tensor]:
    """(rep on the step's device in fp32, Eq. 10 mask, the mask in fp32):
    the top-m of r̂/c^λ, no noise, the lower index first among ties."""
    rep = torch.as_tensor(rep, dtype=torch.float32, device=ranks.device)
    m = min(flcfg.clients_per_round, ranks.topo.n_clients)
    sel_mask = select_clients(rep, ranks.unit_costs, m, flcfg.cost_lambda)
    return rep, sel_mask, sel_mask.to(torch.float32)


def _ema(flcfg: FLConfig, rep: Tensor, sel_mask: Tensor, phi: Tensor
         ) -> Tensor:
    """Eq. 8–9: the selected clients' reputation EMA toward φ's share."""
    n = phi.shape[0]
    phi_sum = torch.sum(phi)
    r = torch.where(phi_sum > EPS, phi / torch.clamp(phi_sum, min=EPS),
                    torch.full_like(phi, 1.0 / n))
    g = flcfg.ema_gamma
    return torch.where(sel_mask, g * rep + (1 - g) * r, rep)


def _normalized(x: Tensor, k: int) -> Tensor:
    """x / Σx, or 1/k everywhere when Σx ≤ ε."""
    s = torch.sum(x)
    return torch.where(s > EPS, x / torch.clamp(s, min=EPS),
                       torch.full_like(x, 1.0 / k))


# ---------------------------------------------------------------------------
# two_phase strategy (paper-faithful)

def make_two_phase_step(model: Model, mesh: MeshLike, flcfg: FLConfig,
                        optimizer, *, loss_chunk: int = 512
                        ) -> Tuple[FLTrainStep, MeshTopology]:
    """``(step, topo)``; ``step(params, opt_state, rep, batch, ref_batch)
    -> (params, opt_state, rep, metrics)``.

    ``batch``: leaves with leading dim = global batch, client-major: each
    client's cohort is global_batch / n_clients rows. ``ref_batch``:
    leaves with leading dim n_clouds, each cloud's trusted reference data
    (paper §IV-D). ``metrics["beta"]`` holds every cloud's β̂ (the
    reference's replicated output reads the first device's: cloud 0's)."""
    cfg = model.cfg
    topo = MeshTopology.from_mesh(mesh, flcfg.n_clouds)
    _, opt_update = optimizer
    grad = model.grad_fn(loss_chunk)
    ranks = _Ranks(topo, flcfg, mesh)
    store = _storage(model, mesh)
    n, k, cpc = topo.n_clients, topo.n_clouds, topo.clients_per_cloud

    def step(params, opt_state, rep, batch, ref_batch):
        r = ranks.start(params)
        dev = r.device
        params, opt_state = store.place(params, opt_state)
        whole = store.gather(params)
        rep, sel_mask, sel = _selection(r, flcfg, rep)
        per = _per_client(batch, n)
        cloud_loc = r.cloud_of[r.clients.start:r.clients.stop]
        clouds_loc = topo.cloud_of()[r.clients.start:r.clients.stop].tolist()
        ref_of = lambda c: {key: v[c] for key, v in ref_batch.items()}  # noqa: E731

        # pass A: keep each gradient's last layer, full norm and loss
        lls, gns, losses = [], [], []
        for i in r.clients:
            (loss, _), g = grad(whole, _rows(batch, i * per, (i + 1) * per))
            lls.append(_last_layer(g, cfg))
            gns.append(_full_norm(g))
            losses.append(loss)
            del g
        ll_ref, gn_ref = [], []
        for c in range(k):
            _, g = grad(whole, ref_of(c))
            ll_ref.append(_last_layer(g, cfg))
            gn_ref.append(_full_norm(g))
            del g
        gn_ref = torch.stack(gn_ref)

        # Eq. 7–9: reputation from the last-layer gradients
        ll_bar = {key: r.all_sum(sum(ll[key].to(torch.float32) for ll in lls))
                  / n for key in lls[0]}
        phi = r.gather(torch.stack([_phi(ll, ll_bar) for ll in lls])) * sel
        del ll_bar
        new_rep = _ema(flcfg, rep, sel_mask, phi)

        # Eq. 11: trust against the own cloud's reference
        ts_loc = torch.stack([
            torch.relu(tree_cos(ll, ll_ref[c])) for ll, c in
            zip(lls, clouds_loc)]) * (new_rep * sel)[r.clients.start:
                                                     r.clients.stop]
        ts = r.gather(ts_loc)
        # Eq. 12: the reference gradient's magnitude over the client's
        coef_loc = gn_ref[cloud_loc] / torch.clamp(torch.stack(gns),
                                                   min=EPS) * ts_loc
        ts_cloud = ts.reshape(k, cpc).sum(1)
        live = (ts_cloud > EPS).tolist()

        # Eq. 6's cloud trust β from each cloud aggregate's last layer
        # (Eq. 13 on the kept last layers; the reference's where ts ≤ ε)
        ll_gref = {key: sum(ll[key].to(torch.float32) for ll in ll_ref) / k
                   for key in ll_ref[0]}
        beta = torch.zeros(k, dtype=torch.float32, device=dev)
        for c in r.clouds:
            if live[c]:
                mine = [j for j, cj in enumerate(clouds_loc) if cj == c]
                ll_c = {}
                for key in ll_gref:
                    buf = torch.zeros_like(ll_gref[key])
                    for j in mine:
                        buf += lls[j][key].to(torch.float32) * coef_loc[j]
                    ll_c[key] = r.intra_sum(buf) / torch.clamp(ts_cloud[c],
                                                               min=EPS)
            else:
                ll_c = ll_ref[c]
            beta[c] = torch.relu(tree_cos(ll_c, ll_gref))
            del ll_c
        beta_n = _normalized(r.cross_sum(beta), k)
        del lls, ll_ref, ll_gref

        # pass B: Σ_k β̂_k·(Σ_i cᵢ·gᵢ / Σ_i tsᵢ), or β̂_k·g_ref where Σ ts ≤ ε
        w_loc = torch.where(ts_cloud[cloud_loc] > EPS,
                            beta_n[cloud_loc] * coef_loc
                            / torch.clamp(ts_cloud[cloud_loc], min=EPS),
                            torch.zeros_like(coef_loc))
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=dev), whole)
        w_host, beta_host = w_loc.tolist(), beta_n.tolist()
        terms = [(_rows(batch, i * per, (i + 1) * per), w_loc[j])
                 for j, i in enumerate(r.clients) if w_host[j] != 0.0]
        terms += [(ref_of(c), beta_n[c]) for c in range(k)
                  if not live[c] and r.owner(c) and beta_host[c] != 0.0]
        for b, w in terms:
            _, g = grad(whole, b)
            for a, x in zip(tree_leaves(acc), tree_leaves(g)):
                a.add_(x.to(torch.float32) * w)
            del g
        del whole
        for a in tree_leaves(acc):
            r.all_sum(a)

        loss_all = r.gather(torch.stack(losses))
        metrics = {
            "loss": torch.sum(loss_all * sel) / torch.clamp(torch.sum(sel),
                                                            min=1.0),
            "phi": phi,
            "trust": ts,
            "beta": beta_n,
            "selected": sel,
            "round_cost_units": torch.sum(sel * r.unit_costs),
        }
        r.agree(tree_leaves(acc) + [new_rep] + list(metrics.values()))
        params, opt_state = store.update(opt_update, acc, opt_state, params)
        return params, opt_state, new_rep, metrics

    return FLTrainStep(step, ranks), topo


# ---------------------------------------------------------------------------
# fused strategy (beyond-paper: signatures, one backward)

def _signatures(params, cfg: ModelConfig, batch: Dict[str, Tensor],
                n_clients: int, omega: Tensor, loss_chunk: int = 512
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """One forward -> per-client (loss, signature, signature-norm).

    signature_i = vec(Σ_t h_t ⊗ ((p_t − y_t) Ω)), Ω the (vocab, sketch)
    Rademacher projection: a JL sketch of the client's lm-head gradient.
    The batch's rows are client-major. As in the reference, positions
    past the last whole chunk (n_chunks·chunk) count in the token total
    but not in the loss or the sketch. Shapes: (N,), (N, D·s), (N,)."""
    h, _, off = tfm.forward_hidden(params, cfg, batch)
    h = h[:, off:]
    b, s, d = h.shape
    per = b // n_clients
    h = h.reshape(n_clients, per, s, d)
    labels = batch["labels"].reshape(n_clients, per, s)
    mask = batch["mask"].to(torch.float32).reshape(n_clients, per, s)
    chunk = min(loss_chunk, s)
    n_chunks = max(1, s // chunk)
    losses = torch.zeros(n_clients, dtype=torch.float32, device=h.device)
    sk = torch.zeros((n_clients, d, omega.shape[1]), dtype=torch.float32,
                     device=h.device)
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        hc, yc, mc = h[:, :, sl], labels[:, :, sl].long(), mask[:, :, sl]
        logits = softcap(tfm.logits_fn(params, cfg, hc),
                         cfg.logit_softcap).to(torch.float32)
        nll = torch.logsumexp(logits, dim=-1) \
            - torch.gather(logits, -1, yc[..., None])[..., 0]
        losses += torch.sum(nll * mc, dim=(1, 2))
        dl = torch.softmax(logits, dim=-1)                  # (N,per,c,V)
        del logits
        dl.scatter_add_(-1, yc[..., None],
                        torch.full(yc.shape + (1,), -1.0, device=dl.device))
        dl *= mc[..., None]
        z = dl @ omega                                      # (N,per,c,s̃)
        del dl
        sk += torch.einsum("nptd,npts->nds", hc.to(torch.float32), z)
    tok = torch.clamp(torch.sum(mask, dim=(1, 2)), min=1.0)
    sigs = sk.reshape(n_clients, -1) / tok[:, None]
    return losses / tok, sigs, torch.linalg.vector_norm(sigs, dim=1)


KeyLike = Union[int, torch.Generator, Tensor]


def draw_omega(key: KeyLike, vocab: int, sketch_dim: int,
               device: torch.device) -> Tensor:
    """The (vocab, sketch_dim) Rademacher projection ±1/√s: from a seed
    (a generator on ``device``), a ``torch.Generator``, or given whole (a
    tensor, e.g. the reference's Ω replayed)."""
    if isinstance(key, Tensor):
        if tuple(key.shape) != (vocab, sketch_dim):
            raise ValueError(f"Ω of shape {tuple(key.shape)}, expected "
                             f"{(vocab, sketch_dim)}")
        return key.to(device=device, dtype=torch.float32)
    gen = key
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator(device=device)
        gen.manual_seed(int(key))
    bits = torch.randint(0, 2, (vocab, sketch_dim), generator=gen,
                         device=gen.device)
    return ((2.0 * bits.to(torch.float32) - 1.0)
            / math.sqrt(sketch_dim)).to(device)


def _weighted_grad(params, cfg: ModelConfig, batch: Dict[str, Tensor],
                   mask: Tensor, denom: Tensor, loss_chunk: int):
    """Gradient of Σ mask·nll / ``denom`` + the MoE aux loss (0 without
    MoE layers) over ``batch``'s rows: a rank's share of the fused
    step's trust-weighted loss, whose denominator spans the global batch.
    Under ``moe.route_over_ranks`` the aux is the rank's share of the
    global batch's, so the ranks' gradients sum to the reference's."""
    xs = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        p = tree_unflatten(params, xs)
        h, aux, off = tfm.forward_hidden(p, cfg, batch)
        lm = chunked_cross_entropy(
            lambda hc: tfm.logits_fn(p, cfg, hc), h[:, off:],
            batch["labels"], mask, chunk=loss_chunk,
            logit_softcap_val=cfg.logit_softcap, denom=denom)
        grads = torch.autograd.grad(lm + aux, xs)
    return tree_unflatten(params, grads)


def make_fused_step(model: Model, mesh: MeshLike, flcfg: FLConfig,
                    optimizer, *, loss_chunk: int = 512
                    ) -> Tuple[FLTrainStep, MeshTopology]:
    """Signature-fused Cost-TrustFL: ``(step, topo)``, ``step(params,
    opt_state, rep, batch, ref_batch, key)`` with ``key`` a seed, a
    ``torch.Generator`` or Ω itself (see :func:`draw_omega`)."""
    cfg = model.cfg
    topo = MeshTopology.from_mesh(mesh, flcfg.n_clouds)
    _, opt_update = optimizer
    ranks = _Ranks(topo, flcfg, mesh)
    store = _storage(model, mesh)
    n, k = topo.n_clients, topo.n_clouds

    def step(params, opt_state, rep, batch, ref_batch, key: KeyLike):
        r = ranks.start(params)
        dev = r.device
        params, opt_state = store.place(params, opt_state)
        whole = store.gather(params)
        omega = draw_omega(key, cfg.vocab_size, flcfg.sketch_dim, dev)
        per = _per_client(batch, n)
        lo, hi = r.i0 * per, (r.i0 + r.n_loc) * per
        # --- per-client signatures from one forward without gradients
        # (MoE layers route this rank's rows with every rank's, as the
        # reference's forward of the whole global batch)
        with torch.no_grad():
            with route_over_ranks(r.group):
                losses_loc, sigs_loc, _ = _signatures(
                    whole, cfg, _rows(batch, lo, hi), r.n_loc, omega,
                    loss_chunk)
            ref_flat = {key_: v.reshape((-1,) + tuple(v.shape[2:]))
                        for key_, v in ref_batch.items()}
            _, ref_sigs, ref_norms = _signatures(whole, cfg, ref_flat, k,
                                                 omega, loss_chunk)
        losses, sigs = r.gather(losses_loc), r.gather(sigs_loc)
        signorm = torch.linalg.vector_norm(sigs, dim=1)
        rep, sel_mask, sel = _selection(r, flcfg, rep)
        cloud_of = r.cloud_of

        # --- Eq. 7–9 on signatures
        sig_bar = torch.mean(sigs, dim=0)
        cos_bar = (sigs @ sig_bar) / torch.clamp(
            signorm * torch.linalg.vector_norm(sig_bar), min=EPS)
        phi = torch.relu(cos_bar) * signorm * sel
        new_rep = _ema(flcfg, rep, sel_mask, phi)

        # --- Eq. 11 against the own cloud's reference signature
        ref_sig = ref_sigs[cloud_of]
        cos_ref = torch.sum(sigs * ref_sig, dim=1) / torch.clamp(
            signorm * torch.linalg.vector_norm(ref_sig, dim=1), min=EPS)
        ts = torch.relu(cos_ref) * new_rep * sel
        # every cosine ≤ 0: reputation-weighted FedAvg over the selected
        ts = torch.where(torch.sum(ts) > EPS, ts, new_rep * sel)

        # --- Eq. 12 proxy, Eq. 5/13 weights and Eq. 6 β in weight space
        scale = ref_norms[cloud_of] / torch.clamp(signorm, min=EPS)
        onehot = torch.nn.functional.one_hot(cloud_of, k).to(torch.float32)
        ts_cloud = onehot.T @ ts
        agg_sig = onehot.T @ (sigs * (ts * scale)[:, None])
        agg_sig = agg_sig / torch.clamp(ts_cloud, min=EPS)[:, None]
        gref_sig = torch.mean(ref_sigs, dim=0)
        beta = torch.relu((agg_sig @ gref_sig) / torch.clamp(
            torch.linalg.vector_norm(agg_sig, dim=1)
            * torch.linalg.vector_norm(gref_sig), min=EPS))
        beta = _normalized(beta, k)
        w = beta[cloud_of] * ts * scale / torch.clamp(ts_cloud[cloud_of],
                                                      min=EPS)

        # --- ONE backward of the trust-weighted loss over this rank's rows
        mask_w = batch["mask"].to(torch.float32) \
            * w.repeat_interleave(per)[:, None]
        denom = torch.clamp(torch.sum(mask_w), min=1.0)
        with route_over_ranks(r.group):
            g = _weighted_grad(whole, cfg, _rows(batch, lo, hi),
                               mask_w[lo:hi], denom, loss_chunk)
        del whole
        for x in tree_leaves(g):
            r.all_sum(x)
        metrics = {
            "loss": torch.sum(losses * sel) / torch.clamp(torch.sum(sel),
                                                          min=1.0),
            "phi": phi, "trust": ts, "beta": beta,
            "selected": sel,
            "round_cost_units": torch.sum(sel * r.unit_costs),
        }
        r.agree(tree_leaves(g) + [new_rep] + list(metrics.values()))
        params, opt_state = store.update(opt_update, g, opt_state, params)
        del g
        return params, opt_state, new_rep, metrics

    return FLTrainStep(step, ranks), topo


def make_fl_train_step(model: Model, mesh: MeshLike, flcfg: FLConfig,
                       optimizer, *, strategy: Optional[str] = None,
                       loss_chunk: int = 512
                       ) -> Tuple[FLTrainStep, MeshTopology]:
    strategy = strategy or model.cfg.fl_strategy
    if strategy == "two_phase":
        return make_two_phase_step(model, mesh, flcfg, optimizer,
                                   loss_chunk=loss_chunk)
    return make_fused_step(model, mesh, flcfg, optimizer,
                           loss_chunk=loss_chunk)


# ---------------------------------------------------------------------------
# plain (non-FL) train step

def make_plain_step(model: Model, mesh, optimizer: Tuple[Callable, Callable],
                    loss_chunk: int = 512) -> Callable:
    """``step(params, opt_state, batch) -> (new_params, new_opt_state,
    {"loss", "lm_loss", "aux_loss"})``: ``model.grad_fn`` then the
    optimizer's update. The update writes into ``params`` and
    ``opt_state``'s moments and returns them (the reference's jitted step
    donates both). ``mesh`` is taken and not used, as in the reference:
    the step is the same with any mesh or ``None``. The step holds the
    card to the port's numerics contract (``resolve_device``: fp32
    matmuls, deterministic cuDNN)."""
    _, opt_update = optimizer
    grad = model.grad_fn(loss_chunk)

    def step(params, opt_state, batch):
        resolve_device(tree_leaves(params)[0].device)
        (loss, metrics), g = grad(params, batch)
        new_params, new_opt = opt_update(g, opt_state, params)
        return new_params, new_opt, {"loss": loss, **metrics}

    return step
