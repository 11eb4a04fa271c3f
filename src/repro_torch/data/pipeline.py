"""Federated data pipeline: builds fixed-size per-client sample tensors
(so client datasets stack into (N_clients, n_samples, ...) arrays
for batched local training) + a reference dataset per cloud (FLTrust-style
trust anchor); and token windows for the language models."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np

from repro_torch.core.fl_types import CloudTopology
from repro_torch.data.partition import dirichlet_partition
from repro_torch.data.synthetic import ImageDataset


@dataclass(frozen=True)
class FederatedData:
    client_x: np.ndarray      # (N, S, ...) fixed-size per-client samples
    client_y: np.ndarray      # (N, S)
    ref_x: np.ndarray         # (K, R, ...) per-cloud reference sets
    ref_y: np.ndarray         # (K, R)
    test_x: np.ndarray
    test_y: np.ndarray
    n_classes: int


def build_federated(ds: ImageDataset, topo: CloudTopology, *,
                    alpha: float = 0.5, samples_per_client: int = 96,
                    ref_samples: int = 100, test_frac: float = 0.15,
                    seed: int = 0) -> FederatedData:
    rng = np.random.default_rng(seed)
    n = len(ds.y)
    n_test = int(n * test_frac)
    perm = rng.permutation(n)
    test_ix, pool_ix = perm[:n_test], perm[n_test:]

    # reference pools: clean IID samples per cloud (the paper's 100-sample
    # trusted set at each edge aggregator)
    ref_ix = pool_ix[: topo.n_clouds * ref_samples].reshape(
        topo.n_clouds, ref_samples)
    train_ix = pool_ix[topo.n_clouds * ref_samples:]

    parts = dirichlet_partition(ds.y[train_ix], topo.n_clients, alpha,
                                seed=seed)
    s = samples_per_client
    cx = np.empty((topo.n_clients, s) + ds.x.shape[1:], np.float32)
    cy = np.empty((topo.n_clients, s), np.int64)
    for i, p in enumerate(parts):
        ix = train_ix[p]
        take = rng.choice(ix, size=s, replace=len(ix) < s)
        cx[i], cy[i] = ds.x[take], ds.y[take]
    return FederatedData(
        client_x=cx, client_y=cy,
        ref_x=ds.x[ref_ix], ref_y=ds.y[ref_ix],
        test_x=ds.x[test_ix], test_y=ds.y[test_ix],
        n_classes=ds.n_classes)


def token_batches(stream: np.ndarray, batch: int, seq: int, seed: int = 0
                  ) -> Iterator[np.ndarray]:
    """Infinite iterator of (batch, seq+1) token windows."""
    rng = np.random.default_rng(seed)
    n = len(stream) - seq - 1
    while True:
        starts = rng.integers(0, n, size=batch)
        yield np.stack([stream[s: s + seq + 1] for s in starts])
