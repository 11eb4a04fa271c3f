"""Per-link compression policy (the paper's hierarchy-first cost logic).

Two link classes exist in the topology:

* **intra** — client → edge-aggregator uplinks (always within a cloud)
  and the edge → global uplink of the cloud co-located with the global
  aggregator; priced at ``c_intra``.
* **cross** — edge → global uplinks of every other cloud (and, on the
  flat baseline path, the direct uplink of any client outside the
  aggregator cloud); priced at ``c_cross``.

A ``LinkPolicy`` assigns one codec per class; the default,
``cross_only``, compresses only the expensive egress links.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from repro_torch.compress.base import Codec
from repro_torch.compress.topk import TopKCodec

POLICIES = ("none", "cross_only", "intra_only", "all")


@dataclass(frozen=True)
class LinkPolicy:
    """Resolved codec per link class."""
    intra: Codec
    cross: Codec

    @property
    def any_active(self) -> bool:
        return not (self.intra.is_identity and self.cross.is_identity)

    def payload_vectors(self, topo, d_params: int, *,
                        hierarchical: bool = True
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Exact wire bytes per client uplink (N,) and per edge→global
        uplink (K,). Hierarchical: every client hop is intra; flat: a
        client's one hop is intra iff co-located with the aggregator.
        The aggregator cloud's edge uplink is intra-class."""
        intra_b = self.intra.payload_bytes(d_params)
        cross_b = self.cross.payload_bytes(d_params)
        if hierarchical:
            client = np.full(topo.n_clients, intra_b, np.float64)
        else:
            same = topo.cloud_of == topo.aggregator_cloud
            client = np.where(same, intra_b, cross_b).astype(np.float64)
        edge = np.full(topo.n_clouds, cross_b, np.float64)
        edge[topo.aggregator_cloud] = intra_b
        return client, edge


def make_codec(name: str, *, ratio: float = 0.1, levels: int = 15) -> Codec:
    """Codec factory: ``none`` | ``topk`` (``qsgd`` comes with a later
    slice of the port)."""
    if name in ("none", None, ""):
        return Codec()
    if name == "topk":
        return TopKCodec(ratio=ratio)
    if name == "qsgd":
        raise NotImplementedError(
            "compressor='qsgd' is not ported yet: it comes with the "
            "stochastic_quantize kernel (ROADMAP queue A item 6, queue B "
            "item 4)")
    raise ValueError(f"unknown compressor {name!r}; known: "
                     "['none', 'qsgd', 'topk']")


def build_link_policy(compressor: str = "none", *, ratio: float = 0.1,
                      levels: int = 15, link_policy: str = "cross_only"
                      ) -> LinkPolicy:
    """Resolve (compressor, link_policy) config knobs into per-link codecs."""
    if link_policy not in POLICIES:
        raise ValueError(f"unknown link_policy {link_policy!r}; "
                         f"known: {POLICIES}")
    codec = make_codec(compressor, ratio=ratio, levels=levels)
    identity = Codec()
    if codec.is_identity or link_policy == "none":
        return LinkPolicy(intra=identity, cross=identity)
    if link_policy == "cross_only":
        return LinkPolicy(intra=identity, cross=codec)
    if link_policy == "intra_only":
        return LinkPolicy(intra=codec, cross=identity)
    return LinkPolicy(intra=codec, cross=codec)
