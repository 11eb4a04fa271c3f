"""Codec protocol, codec registry and error feedback for gradient
compression.

A *codec* maps a batch of flat updates (N, D) to what the receiver
decodes (``roundtrip``, the round's path) and states the exact wire size
(``payload_bytes``); ``encode``/``decode`` give the structured wire form
(``CompressedUpdate``) for users and tests. Error feedback keeps a
per-sender residual r_t:

    y_t = x_t + r_{t-1};   x̂_t = roundtrip(y_t);   r_t = y_t - x̂_t

so no signal is lost, only delayed.

Stochastic codecs (QSGD) take one row of uniform noise per sender,
``noise`` (N, D): the caller draws row i from the stream of the client
that sent it, never from its position in the batch. Deterministic
codecs ignore it.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

Tensor = torch.Tensor

FP32_BYTES = 4


@dataclass(frozen=True)
class CompressedUpdate:
    """Structured wire form of one batch of updates."""
    kind: str                       # codec name
    data: Dict[str, Any]            # codec-specific tensors
    shape: Tuple[int, int]          # uncompressed (N, D)
    nbytes_per_row: int             # exact wire bytes for ONE update


class Codec:
    """Base codec: fp32 passthrough (the ``none`` codec)."""
    name = "none"

    @property
    def is_identity(self) -> bool:
        return True

    @property
    def needs_noise(self) -> bool:
        """Whether ``roundtrip`` reads per-sender uniform noise."""
        return False

    def payload_bytes(self, d: int) -> int:
        """Exact wire bytes for one D-dim update."""
        return FP32_BYTES * d

    def encode(self, x: Tensor, noise: Optional[Tensor] = None
               ) -> CompressedUpdate:
        """The wire form of the rows of ``x``."""
        return CompressedUpdate(self.name, {"values": x}, tuple(x.shape),
                                self.payload_bytes(x.shape[1]))

    def decode(self, c: CompressedUpdate) -> Tensor:
        """The rows a receiver rebuilds from ``c``."""
        return c.data["values"]

    def roundtrip(self, x: Tensor, noise: Optional[Tensor] = None) -> Tensor:
        """What the receiver decodes for the rows of ``x``."""
        return x

    def roundtrip_residual(self, y: Tensor, noise: Optional[Tensor] = None
                           ) -> Tuple[Tensor, Tensor]:
        """(x̂, y − x̂): the round trip and the error-feedback residual."""
        x_hat = self.roundtrip(y, noise)
        return x_hat, y - x_hat


def ef_step(codec: Codec, x: Tensor, residual: Tensor,
            noise: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """One error-feedback round: (x̂ transmitted, new residual)."""
    if codec.is_identity:
        return x, residual
    return codec.roundtrip_residual(x + residual, noise)


def ef_step_masked(codec: Codec, x: Tensor, residual: Tensor,
                   row_mask: Tensor, noise: Optional[Tensor] = None
                   ) -> Tuple[Tensor, Tensor]:
    """One fixed-shape error-feedback round: rows where ``row_mask`` is
    False pass through untouched and KEEP their residual (nothing
    crossed the wire for them). Returns (x̂ transmitted, new residual)."""
    if codec.is_identity:
        return x, residual
    x_hat, new_res = codec.roundtrip_residual(x + residual, noise)
    keep = row_mask[:, None]
    return torch.where(keep, x_hat, x), torch.where(keep, new_res, residual)


_REGISTRY: Dict[str, Any] = {}


def register_codec(name: str):
    """Class decorator: ``make_codec(name)`` builds the class."""
    def deco(cls):
        _REGISTRY[name] = cls
        return cls
    return deco


def make_codec(name: str, *, ratio: float = 0.1, levels: int = 15) -> Codec:
    """Codec factory: ``none`` | ``topk`` | ``qsgd`` | a registered name
    (``topk`` takes ``ratio``, every other codec ``levels``)."""
    if name in ("none", None, ""):
        return Codec()
    if name not in _REGISTRY:
        known = ["none"] + sorted(_REGISTRY)
        raise ValueError(f"unknown compressor {name!r}; known: {known}")
    if name == "topk":
        return _REGISTRY[name](ratio=ratio)
    return _REGISTRY[name](levels=levels)
