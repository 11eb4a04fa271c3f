"""Codec protocol and error feedback for gradient compression.

A *codec* maps a batch of flat updates (N, D) to what the receiver
decodes (``roundtrip``) and states the exact wire size
(``payload_bytes``). Error feedback keeps a per-sender residual r_t:

    y_t = x_t + r_{t-1};   x̂_t = roundtrip(y_t);   r_t = y_t - x̂_t

so no signal is lost, only delayed.
"""
from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor

FP32_BYTES = 4


class Codec:
    """Base codec: fp32 passthrough (the ``none`` codec)."""
    name = "none"

    @property
    def is_identity(self) -> bool:
        return True

    def payload_bytes(self, d: int) -> int:
        """Exact wire bytes for one D-dim update."""
        return FP32_BYTES * d

    def roundtrip(self, x: Tensor) -> Tensor:
        """What the receiver decodes for the rows of ``x``."""
        return x


def ef_step_masked(codec: Codec, x: Tensor, residual: Tensor,
                   row_mask: Tensor) -> Tuple[Tensor, Tensor]:
    """One fixed-shape error-feedback round: rows where ``row_mask`` is
    False pass through untouched and KEEP their residual (nothing
    crossed the wire for them). Returns (x̂ transmitted, new residual)."""
    if codec.is_identity:
        return x, residual
    y = x + residual
    x_hat = codec.roundtrip(y)
    keep = row_mask[:, None]
    return torch.where(keep, x_hat, x), torch.where(keep, y - x_hat, residual)
