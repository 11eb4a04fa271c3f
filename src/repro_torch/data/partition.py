"""Federated partitioning: the non-IID Dirichlet(α) label-skew split
(paper §V-A, [Zhao et al. 2018]) and an IID split."""
from __future__ import annotations

from typing import List

import numpy as np


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        seed: int = 0, min_size: int = 8) -> List[np.ndarray]:
    """Returns per-client index arrays; class proportions per client are
    drawn from Dirichlet(α) — lower α, more heterogeneity."""
    rng = np.random.default_rng(seed)
    n_classes = int(labels.max()) + 1
    while True:
        idx_per_client: List[List[int]] = [[] for _ in range(n_clients)]
        for c in range(n_classes):
            idx_c = np.nonzero(labels == c)[0]
            rng.shuffle(idx_c)
            props = rng.dirichlet(np.full(n_clients, alpha))
            cuts = (np.cumsum(props) * len(idx_c)).astype(int)[:-1]
            for i, part in enumerate(np.split(idx_c, cuts)):
                idx_per_client[i].extend(part.tolist())
        sizes = [len(ix) for ix in idx_per_client]
        if min(sizes) >= min_size:
            break
        alpha *= 1.5   # retry with slightly more uniformity to avoid empties
    return [np.array(sorted(ix)) for ix in idx_per_client]


def iid_partition(n: int, n_clients: int, seed: int = 0) -> List[np.ndarray]:
    """A seeded permutation of range(n) split into ``n_clients`` near-equal
    parts, each sorted."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    return [np.sort(p) for p in np.array_split(perm, n_clients)]
