"""Telemetry event schema: the typed per-round record both round loops
emit, and the host-side :class:`RunContext` factory that builds the
records.

One schema, several producers. The round engine's per-round driver
(``FLServer``), the host round loop and ``run_simulation_batch`` (live
through the tap of ``Engine.run``, or replayed from its stacked outputs)
all pass their raw round outputs (delivered mask, reputation vector,
params-L2 digest) through the SAME ``RunContext.round`` code path, as
numpy arrays, so two drivers that agree on the raw arrays emit
byte-identical JSONL lines. The schema, the field order and the float64
accounting are the reference's (``repro.telemetry``), so a stream of the
port and one of the reference diff line by line.

Event types (``event`` field):

* ``run_start`` — config echo + optional provenance stamp;
* ``round``     — the per-round record (see ``ROUND_REQUIRED``);
* ``eval``      — accuracy (and optionally loss) when an eval ran;
* ``span``      — a named host-side timing span (compile vs execute);
* ``run_end``   — cumulative totals at shutdown.

``round`` events carry a ``digest`` — cheap scalars (params L2,
reputation L2/sum, a delivered-mask SHA) that fingerprint the
``RoundState`` without shipping it.

Validation is hand-rolled (:func:`validate_event`) — no jsonschema
dependency.

v1.1 adds the multi-feature trust fields to ``round`` events:
``trust_features`` (the ``FLConfig.trust_features`` mode, or null) and
``feat_weights`` (the softmax-normalized adaptive feature weights after
this round's EMA update, or null on scalar runs). Both are nullable.

The engine names are the reference's: ``"jit"`` is the round engine
(``Engine.step``; the port runs it eagerly), ``"host"`` the host round
loop; ``"shard"`` is kept so the reference's streams validate.
"""
from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.cost import CostModel
from repro_torch.core.fl_types import CloudTopology

SCHEMA = "cost-trustfl/telemetry/v1.1"

EVENT_TYPES = ("run_start", "round", "eval", "span", "run_end")

ENGINES = ("host", "jit", "shard")

# required fields per event type: name -> allowed python types. ``None``
# entries in _NULLABLE may also be null. ``digest`` is validated
# separately (nested).
_NUM = (int, float)
ROUND_REQUIRED: Dict[str, tuple] = {
    "run_id": (str,), "engine": (str,), "method": (str,), "attack": (str,),
    "seed": (int,), "t": (int,),
    "n_selected": (int,), "n_delivered": (int,), "n_active_malicious": (int,),
    "intra_bytes": _NUM, "cross_bytes": _NUM, "cost": _NUM,
    "cum_cost": _NUM, "cum_intra_bytes": _NUM, "cum_cross_bytes": _NUM,
    "price_mult": _NUM, "compression_ratio": _NUM,
    "rep_mean": _NUM, "rep_min": _NUM, "rep_max": _NUM,
    "digest": (dict,),
}
DIGEST_REQUIRED: Dict[str, tuple] = {
    "params_l2": _NUM, "rep_l2": _NUM, "rep_sum": _NUM,
    "delivered_sha": (str,),
}
_REQUIRED: Dict[str, Dict[str, tuple]] = {
    "run_start": {"run_id": (str,), "engine": (str,), "method": (str,),
                  "attack": (str,), "seed": (int,)},
    "round": ROUND_REQUIRED,
    "eval": {"run_id": (str,), "engine": (str,), "t": (int,),
             "accuracy": _NUM},
    "span": {"name": (str,), "seconds": _NUM},
    "run_end": {"run_id": (str,), "engine": (str,), "rounds_emitted": (int,),
                "cum_cost": _NUM},
}
# nullable optional fields (validated only when present and non-null)
_NULLABLE: Dict[str, tuple] = {
    "scenario": (str,), "rep_honest_mean": _NUM, "rep_malicious_mean": _NUM,
    "loss": _NUM, "rounds": (int,), "config": (dict,), "provenance": (dict,),
    "run_id": (str,), "engine": (str,), "phase": (str,), "t": (int,),
    # v1.1: multi-feature trust path (null on scalar runs, so v1 streams
    # and scalar v1.1 streams stay byte-compatible field-for-field)
    "trust_features": (str,), "feat_weights": (list,),
}


def validate_event(ev: Any) -> List[str]:
    """Schema-check one decoded event; returns error strings (empty =
    valid). Unknown extra fields pass — the schema is open for forward
    compatibility; missing/mistyped required fields fail."""
    errs: List[str] = []
    if not isinstance(ev, dict):
        return [f"event is {type(ev).__name__}, not object"]
    if ev.get("schema") != SCHEMA:
        errs.append(f"schema is {ev.get('schema')!r}, expected {SCHEMA!r}")
    kind = ev.get("event")
    if kind not in EVENT_TYPES:
        errs.append(f"event is {kind!r}, expected one of {EVENT_TYPES}")
        return errs
    for name, types in _REQUIRED[kind].items():
        v = ev.get(name)
        if not isinstance(v, types) or isinstance(v, bool):
            errs.append(f"{kind}.{name}: {v!r} is not {types}")
    if kind == "round" and isinstance(ev.get("digest"), dict):
        for name, types in DIGEST_REQUIRED.items():
            v = ev["digest"].get(name)
            if not isinstance(v, types) or isinstance(v, bool):
                errs.append(f"round.digest.{name}: {v!r} is not {types}")
    if "engine" in ev and ev["engine"] is not None \
            and ev["engine"] not in ENGINES:
        errs.append(f"{kind}.engine: {ev['engine']!r} not in {ENGINES}")
    for name, types in _NULLABLE.items():
        if name in _REQUIRED[kind] or name not in ev or ev[name] is None:
            continue
        if not isinstance(ev[name], types) or isinstance(ev[name], bool):
            errs.append(f"{kind}.{name}: {ev[name]!r} is not {types}")
    if isinstance(ev.get("feat_weights"), list):
        for i, w in enumerate(ev["feat_weights"]):
            if not isinstance(w, _NUM) or isinstance(w, bool):
                errs.append(f"{kind}.feat_weights[{i}]: {w!r} is not {_NUM}")
    return errs


def validate_events(events: Iterable[Any]) -> List[str]:
    """Validate a decoded event stream; errors are prefixed ``#<i>``."""
    errs: List[str] = []
    for i, ev in enumerate(events):
        errs.extend(f"#{i}: {e}" for e in validate_event(ev))
    return errs


def encode(ev: Dict[str, Any]) -> str:
    """The canonical JSONL encoding (insertion-ordered keys, compact
    separators) — byte-stable given equal event dicts."""
    return json.dumps(ev, separators=(",", ":"), allow_nan=False)


def delivered_sha(delivered: np.ndarray) -> str:
    """Short content hash of the delivered mask (bit-packed, so the
    digest is a function of the mask alone, not numpy's memory layout)."""
    packed = np.packbits(np.asarray(delivered, bool))
    return hashlib.sha256(packed.tobytes()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# the event factory

class RunContext:
    """Per-run event factory: holds the static config slice every round
    event needs plus the running totals, and emits to a ``Telemetry``
    recorder (or any object with ``emit(dict)``).

    ``client_payload``/``edge_payload`` are the exact per-link wire
    bytes (``LinkPolicy.payload_vectors``); accounting inside
    :meth:`round` then reproduces ``engine.host_round_accounting``
    float64-exactly — CostModel at the round's surge price over the
    delivered mask — so events agree with ``SimResult`` totals to the
    last bit. Drivers that computed the round's $ themselves (the host
    loop under host-hook pricing) pass explicit overrides instead.
    """

    def __init__(self, telemetry: Any, *, engine: str, run_id: str,
                 method: str, attack: str, seed: int,
                 topo: CloudTopology, d_params: int, hierarchical: bool,
                 m_selected: int, malicious: np.ndarray,
                 client_payload: Optional[np.ndarray] = None,
                 edge_payload: Optional[np.ndarray] = None,
                 c_intra: float = 0.01, c_cross: float = 0.09,
                 price_multipliers: Sequence[float] = (1.0,),
                 malice_warmup: int = 0,
                 scenario: Optional[str] = None,
                 trust_features: Optional[str] = None):
        self.telemetry = telemetry
        self.engine = engine
        self.run_id = run_id
        self.method = method
        self.attack = attack
        self.scenario = scenario
        self.trust_features = trust_features
        self.seed = int(seed)
        self.topo = topo
        self.d_params = int(d_params)
        self.hierarchical = bool(hierarchical)
        self.m_selected = int(m_selected)
        self.malicious = np.asarray(malicious, bool)
        self.client_payload = client_payload
        self.edge_payload = edge_payload
        self.c_intra = float(c_intra)
        self.c_cross = float(c_cross)
        self.price_multipliers = tuple(float(m) for m in price_multipliers)
        self.malice_warmup = int(malice_warmup)
        self.cum_cost = 0.0
        self.cum_intra = 0.0
        self.cum_cross = 0.0
        self.rounds_emitted = 0

    # -- emission -----------------------------------------------------------
    def _emit(self, ev: Dict[str, Any]) -> Dict[str, Any]:
        if self.telemetry is not None:
            self.telemetry.emit(ev)
        return ev

    def _base(self, event: str) -> Dict[str, Any]:
        return {"schema": SCHEMA, "event": event, "run_id": self.run_id,
                "engine": self.engine}

    def run_start(self, *, rounds: Optional[int] = None,
                  config: Optional[Dict[str, Any]] = None,
                  provenance: Optional[Dict[str, Any]] = None
                  ) -> Dict[str, Any]:
        ev = self._base("run_start")
        ev.update(method=self.method, attack=self.attack,
                  scenario=self.scenario, seed=self.seed, rounds=rounds,
                  config=config, provenance=provenance)
        return self._emit(ev)

    def _account(self, t: int, delivered: np.ndarray
                 ) -> Tuple[float, float, float, float]:
        """(cost, intra_bytes, cross_bytes, price_mult) at this round's
        surge price — the same float64 reduction as
        ``engine.host_round_accounting`` (one delivered row, t0=t)."""
        mults = self.price_multipliers
        mult = mults[t % len(mults)]
        cm = CostModel(self.c_intra, self.c_cross * mult)
        intra_b, cross_b = cm.round_bytes(
            self.topo, delivered, self.d_params,
            hierarchical=self.hierarchical,
            client_payload=self.client_payload,
            edge_payload=self.edge_payload)
        cost = cm.round_cost(
            self.topo, delivered, self.d_params,
            hierarchical=self.hierarchical,
            client_payload=self.client_payload,
            edge_payload=self.edge_payload)
        return float(cost), float(intra_b), float(cross_b), float(mult)

    def round(self, t: int, delivered: np.ndarray, rep: np.ndarray,
              params_l2: float, *, cost: Optional[float] = None,
              intra_bytes: Optional[float] = None,
              cross_bytes: Optional[float] = None,
              price_mult: Optional[float] = None,
              feat_weights: Optional[np.ndarray] = None) -> Dict[str, Any]:
        """Build + emit one ``round`` event from the raw round outputs.

        ``delivered``/``rep`` are the (N,) mask and post-update
        reputation as numpy arrays, ``rep`` in the float32 the round
        produced (a float64 copy changes ``rep_mean``'s last bits, and
        so the line's bytes); ``params_l2`` the state digest
        (``RoundOut.params_l2``) as ``float()`` of a float32 scalar.
        Accounting defaults to the internal float64 path; explicit
        ``cost``/bytes override it (the host loop under host-hook
        pricing, where only the driver knows the mutated prices)."""
        t = int(t)
        delivered = np.asarray(delivered, bool)
        rep = np.asarray(rep)
        if cost is None or intra_bytes is None or cross_bytes is None:
            cost, intra_bytes, cross_bytes, mult = self._account(t, delivered)
        else:
            mults = self.price_multipliers
            mult = (float(price_mult) if price_mult is not None
                    else mults[t % len(mults)])
        self.cum_cost += cost
        self.cum_intra += intra_bytes
        self.cum_cross += cross_bytes
        self.rounds_emitted += 1

        # compression ratio: billed bytes vs the same mask shipped as
        # dense fp32 (payload=None defaults in CostModel)
        dense_i, dense_c = CostModel(self.c_intra, self.c_cross).round_bytes(
            self.topo, delivered, self.d_params,
            hierarchical=self.hierarchical)
        dense = dense_i + dense_c
        ratio = (intra_bytes + cross_bytes) / dense if dense > 0 else 1.0

        active_mal = (self.malicious if t >= self.malice_warmup
                      else np.zeros_like(self.malicious))
        hon = ~self.malicious
        rep64 = rep.astype(np.float64)
        ev = self._base("round")
        ev.update(
            method=self.method, attack=self.attack, scenario=self.scenario,
            seed=self.seed, t=t,
            n_selected=self.m_selected,
            n_delivered=int(delivered.sum()),
            n_active_malicious=int((active_mal & delivered).sum()),
            intra_bytes=float(intra_bytes), cross_bytes=float(cross_bytes),
            cost=float(cost), cum_cost=self.cum_cost,
            cum_intra_bytes=self.cum_intra, cum_cross_bytes=self.cum_cross,
            price_mult=float(mult), compression_ratio=float(ratio),
            rep_mean=float(rep64.mean()), rep_min=float(rep64.min()),
            rep_max=float(rep64.max()),
            rep_honest_mean=(float(rep64[hon].mean()) if hon.any()
                             else None),
            rep_malicious_mean=(float(rep64[self.malicious].mean())
                                if self.malicious.any() else None),
            trust_features=self.trust_features,
            feat_weights=(None if feat_weights is None
                          else [float(w) for w in np.asarray(feat_weights)]),
            digest={"params_l2": float(params_l2),
                    "rep_l2": float(np.linalg.norm(rep64)),
                    "rep_sum": float(rep64.sum()),
                    "delivered_sha": delivered_sha(delivered)})
        return self._emit(ev)

    def eval(self, t: int, accuracy: float,
             loss: Optional[float] = None) -> Dict[str, Any]:
        ev = self._base("eval")
        ev.update(t=int(t), accuracy=float(accuracy),
                  loss=None if loss is None else float(loss))
        return self._emit(ev)

    def span(self, name: str, seconds: float, *,
             phase: Optional[str] = None,
             t: Optional[int] = None) -> Dict[str, Any]:
        ev = self._base("span")
        ev.update(name=name, seconds=float(seconds), phase=phase,
                  t=None if t is None else int(t))
        return self._emit(ev)

    def run_end(self) -> Dict[str, Any]:
        ev = self._base("run_end")
        ev.update(rounds_emitted=self.rounds_emitted,
                  cum_cost=self.cum_cost, cum_intra_bytes=self.cum_intra,
                  cum_cross_bytes=self.cum_cross)
        return self._emit(ev)
