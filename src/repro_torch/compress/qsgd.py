"""QSGD-style stochastic quantization codec (linf-scaled, unbiased).

Per row: scale s = max|x|, levels q = sign(x)·min(⌊|x|/s·L + u⌋, L) with
u ~ U[0, 1), decoded as x̂ = q·s/L, so E[x̂] = x. Wire format: a 4-byte
fp32 scale plus D entries packed at ⌈log2(2L+1)⌉ bits each (L = 15: 5
bits a coordinate, 6.4× below fp32).

``roundtrip_residual`` is one ``stochastic_quantize`` launch in its
fused mode: quantize, dequantize and the error-feedback residual in one
pass; the scale is a ``torch.amax`` outside, as in the reference.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.compress.base import FP32_BYTES, Codec
from repro_torch.kernels import ops

Tensor = torch.Tensor


@dataclass(frozen=True)
class QSGDCodec(Codec):
    """Stochastic quantization to 2·levels+1 states per coordinate."""
    levels: int = 15
    name = "qsgd"

    @property
    def is_identity(self) -> bool:
        return False

    @property
    def needs_noise(self) -> bool:
        return True

    @property
    def bits_per_coord(self) -> int:
        return max(1, math.ceil(math.log2(2 * self.levels + 1)))

    def payload_bytes(self, d: int) -> int:
        return FP32_BYTES + math.ceil(d * self.bits_per_coord / 8)

    def roundtrip_residual(self, y: Tensor, noise: Optional[Tensor] = None
                           ) -> Tuple[Tensor, Tensor]:
        if noise is None:
            raise ValueError("QSGD needs one row of uniform noise per sender")
        scale = torch.amax(torch.abs(y), dim=1)
        return ops.quantize_roundtrip(y, scale, noise, levels=self.levels)

    def roundtrip(self, x: Tensor, noise: Optional[Tensor] = None) -> Tensor:
        return self.roundtrip_residual(x, noise)[0].to(x.dtype)
