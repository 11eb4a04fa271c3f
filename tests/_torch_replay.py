"""Shared helpers of the port's round-parity tests: the reference
engine's per-round randomness re-derived from its key schedule and
handed to ``repro_torch``'s ``Engine.step`` in replay mode, plus the
comparison measures. Not a test module (leading underscore)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.federated import engine as jengine
from repro_torch.federated import engine as tengine


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
                    d: int = 0, k: int = 0, edge_fold: int = 3
                    ) -> tengine.RoundDraws:
    """The reference engine's round-t randomness (engine.py: round_key,
    fold 131 for selection noise, split(key, N)[i] per client, the round
    key itself for the refs). With ``d`` > 0 also the QSGD wire noise:
    the client wire's ``fold_in(fold_in(key, 211), client)`` rows for all
    N clients and, with ``k`` > 0, the edge wire's
    ``fold_in(fold_in(fold_in(key, 223), edge_fold), cloud)`` rows."""
    key = jengine.round_key(jnp.int32(seed), jnp.int32(t))
    noise = jax.random.normal(jax.random.fold_in(key, 131), (n,),
                              jnp.float32)
    keys = jax.random.split(key, n)
    cidx = np.stack([minibatch_idx(keys[i], steps, batch, n_samples)
                     for i in range(n)])
    ridx = minibatch_idx(key, ref_steps, tengine.REF_BATCH, n_ref)
    client_noise = edge_noise = None
    if d:
        client_noise = torch.tensor(_uniform_rows(
            jax.random.fold_in(key, 211), np.arange(n), d))
    if d and k:
        ekey = jax.random.fold_in(jax.random.fold_in(key, 223), edge_fold)
        edge_noise = torch.tensor(_uniform_rows(ekey, np.arange(k), d))
    return tengine.RoundDraws(torch.tensor(np.asarray(noise)),
                              torch.tensor(cidx), torch.tensor(ridx),
                              client_noise=client_noise,
                              edge_noise=edge_noise)
