"""Update-level poisoning attacks: transforms of the malicious rows of an
(m, D) update matrix, dispatched by name through ``UPDATE_ATTACKS`` (the
port of ``repro/core/attacks.py``).

Static (paper Table I): ``gaussian`` (additive N(0, σ²) noise),
``sign_flip`` (g ← −scale·g), ``scaling`` (g ← scale·g); ``label_flip``
poisons data (``federated.engine.poison_labels``; :func:`flip_labels`
for users) and is the identity here. Adaptive: ``alie`` (mean − z·std of
the honest rows), ``alie_norm`` (the same point rescaled to the honest
median norm, so the Eq. 7 median damp reads it as typical), ``ipm``
(−scale·mean of the honest rows),
``min_max`` (largest step along −mean that stays inside the honest
pairwise-distance envelope, 20-step bisection) and ``collusion`` (every
colluder sends −scale·their mean).

``valid`` (bool (m,), optional) excludes rows that never delivered from
the honest statistics. ``gaussian`` takes its (m, D) standard normals
from the caller (``noise``): the engine draws them from its own stream
or replays the reference's ``normal(round_key, (m, D))``. Users add an
attack with :func:`register_update_attack`; ``FLConfig.attack`` then
names it and the round loops run it through :func:`apply_update_attack`.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

Tensor = torch.Tensor

EPS = 1e-12


def flip_labels(labels: Tensor, n_classes: int, mask: Tensor,
                generator: torch.Generator) -> Tensor:
    """Label flipping: every label where ``mask`` is set moves by an
    offset drawn uniformly from [1, n_classes) from ``generator`` (on
    ``labels``' device), modulo ``n_classes``; the others stay."""
    offset = torch.randint(1, n_classes, labels.shape, generator=generator,
                           device=labels.device, dtype=labels.dtype)
    return torch.where(mask, (labels + offset) % n_classes, labels)


def _honest(malicious: Tensor, valid: Optional[Tensor]) -> Tensor:
    return ~malicious if valid is None else (~malicious) & valid


def _honest_moments(updates: Tensor, malicious: Tensor,
                    valid: Optional[Tensor] = None,
                    eps: float = EPS) -> Tuple[Tensor, Tensor]:
    """Per-coordinate (mean, std) over the honest rows of (m, D)."""
    w = _honest(malicious, valid).to(updates.dtype)[:, None]
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(updates * w, dim=0) / n
    var = torch.sum(((updates - mean) ** 2) * w, dim=0) / n
    return mean, torch.sqrt(torch.clamp(var, min=eps * eps))


def _rows(malicious: Tensor, point: Tensor, updates: Tensor) -> Tensor:
    return torch.where(malicious[:, None], point, updates)


def gaussian_attack(updates: Tensor, malicious: Tensor, noise: Tensor,
                    sigma: float = 1.0) -> Tensor:
    """g_i += σ·noise_i for malicious rows (``noise`` standard normals)."""
    return _rows(malicious, updates + sigma * noise, updates)


def sign_flip_attack(updates: Tensor, malicious: Tensor,
                     scale: float = 1.0) -> Tensor:
    return _rows(malicious, -scale * updates, updates)


def scaling_attack(updates: Tensor, malicious: Tensor,
                   scale: float = 10.0) -> Tensor:
    return _rows(malicious, scale * updates, updates)


def alie_attack(updates: Tensor, malicious: Tensor, z: float = 1.0,
                valid: Optional[Tensor] = None) -> Tensor:
    mean, std = _honest_moments(updates, malicious, valid)
    return _rows(malicious, (mean - z * std)[None], updates)


def alie_norm_attack(updates: Tensor, malicious: Tensor, z: float = 1.0,
                     valid: Optional[Tensor] = None,
                     eps: float = EPS) -> Tensor:
    """ALIE rescaled to the honest rows' median norm (the 0.5 quantile
    averages the middle pair, as ``jnp.nanmedian`` does)."""
    mean, std = _honest_moments(updates, malicious, valid, eps)
    point = mean - z * std
    norms = torch.linalg.vector_norm(updates, dim=1)
    med = torch.nanquantile(
        torch.where(_honest(malicious, valid), norms,
                    torch.full_like(norms, float("nan"))), 0.5)
    med = torch.where(torch.isnan(med) | ~(med > 0),
                      torch.ones_like(med), med)
    point = point * (med / torch.clamp(torch.linalg.vector_norm(point),
                                       min=eps))
    return _rows(malicious, point[None], updates)


def ipm_attack(updates: Tensor, malicious: Tensor, scale: float = 2.0,
               valid: Optional[Tensor] = None) -> Tensor:
    mean, _ = _honest_moments(updates, malicious, valid)
    return _rows(malicious, (-scale * mean)[None], updates)


def min_max_attack(updates: Tensor, malicious: Tensor, *, iters: int = 20,
                   valid: Optional[Tensor] = None,
                   eps: float = EPS) -> Tensor:
    """mean(honest) + γ·p, p = −mean/‖mean‖, γ the largest value (by
    bisection) keeping the row within the maximum honest pairwise
    distance of every honest row."""
    honest = _honest(malicious, valid)
    w = honest.to(updates.dtype)
    mean, _ = _honest_moments(updates, malicious, valid)
    p = -mean / torch.clamp(torch.linalg.vector_norm(mean), min=eps)

    sq = torch.sum(updates * updates, dim=1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (updates @ updates.T)
    d_max = torch.sqrt(torch.clamp(torch.max(d2 * w[:, None] * w[None, :]),
                                   min=0.0))
    mean_sq = torch.sum(mean * mean)
    mean_p = mean @ p
    dot_up = updates @ p
    dot_um = updates @ mean
    neg_inf = torch.full_like(sq, float("-inf"))

    def worst_dist(gamma: Tensor) -> Tensor:
        cand_sq = mean_sq + 2.0 * gamma * mean_p + gamma * gamma
        d = cand_sq + sq - 2.0 * (dot_um + gamma * dot_up)
        return torch.sqrt(torch.clamp(torch.max(torch.where(honest, d,
                                                            neg_inf)),
                                      min=0.0))

    lo = torch.zeros((), dtype=updates.dtype, device=updates.device)
    hi = 2.0 * d_max + eps
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        ok = worst_dist(mid) <= d_max
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return _rows(malicious, (mean + lo * p)[None], updates)


def collusion_attack(updates: Tensor, malicious: Tensor, scale: float = 1.0,
                     valid: Optional[Tensor] = None) -> Tensor:
    colluders = malicious if valid is None else malicious & valid
    w = colluders.to(updates.dtype)
    mal_mean = (w @ updates) / torch.clamp(torch.sum(w), min=1.0)
    return _rows(malicious, (-scale * mal_mean)[None], updates)


# -- registry -----------------------------------------------------------------
# fn(updates, malicious, noise, *, sigma, scale, z[, valid]); None marks
# the names handled at the data level (label_flip) or not at all (none).
# ``noise`` is the (m, D) standard normals for the NOISY_ATTACKS and may
# be None for any other; ``valid`` is passed only when some row did not
# deliver, so an adapter without it keeps working under full delivery.
AttackFn = Callable[..., Tensor]

UPDATE_ATTACKS: Dict[str, Optional[AttackFn]] = {}


def register_update_attack(name: str, fn: Optional[AttackFn]) -> None:
    """Make ``name`` an attack ``FLConfig.attack`` can name (``None``:
    the identity on updates)."""
    UPDATE_ATTACKS[name] = fn


register_update_attack("none", None)
register_update_attack("label_flip", None)   # data level, see flip_labels
register_update_attack(
    "gaussian", lambda u, m, n, *, sigma, scale, z, valid=None:
        gaussian_attack(u, m, n, sigma))
register_update_attack(
    "sign_flip", lambda u, m, n, *, sigma, scale, z, valid=None:
        sign_flip_attack(u, m, scale))
register_update_attack(
    "scaling", lambda u, m, n, *, sigma, scale, z, valid=None:
        scaling_attack(u, m, scale))
register_update_attack(
    "alie", lambda u, m, n, *, sigma, scale, z, valid=None:
        alie_attack(u, m, z, valid))
register_update_attack(
    "alie_norm", lambda u, m, n, *, sigma, scale, z, valid=None:
        alie_norm_attack(u, m, z, valid))
register_update_attack(
    "ipm", lambda u, m, n, *, sigma, scale, z, valid=None:
        ipm_attack(u, m, scale, valid))
register_update_attack(
    "min_max", lambda u, m, n, *, sigma, scale, z, valid=None:
        min_max_attack(u, m, valid=valid))
register_update_attack(
    "collusion", lambda u, m, n, *, sigma, scale, z, valid=None:
        collusion_attack(u, m, scale, valid))

# attacks that read the caller's (m, D) standard normals
NOISY_ATTACKS = ("gaussian",)


def apply_update_attack(name: str, updates: Tensor, malicious: Tensor,
                        noise: Optional[Tensor] = None, *,
                        sigma: float = 1.0, scale: float = 10.0,
                        z: float = 1.0,
                        valid: Optional[Tensor] = None) -> Tensor:
    """Apply attack ``name`` to the rows of ``updates`` where
    ``malicious`` is set."""
    if name not in UPDATE_ATTACKS:
        raise ValueError(f"unknown attack {name!r}; known: "
                         f"{sorted(UPDATE_ATTACKS)}")
    fn = UPDATE_ATTACKS[name]
    if fn is None:
        return updates
    if name in NOISY_ATTACKS and noise is None:
        raise ValueError(f"attack {name!r} needs its (m, D) normals")
    if valid is None:
        return fn(updates, malicious, noise, sigma=sigma, scale=scale, z=z)
    return fn(updates, malicious, noise, sigma=sigma, scale=scale, z=z,
              valid=valid)


# the built-in attacks' names, in the order they were registered
ATTACKS = tuple(UPDATE_ATTACKS)
