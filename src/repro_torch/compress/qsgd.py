"""QSGD-style stochastic quantization codec (linf-scaled, unbiased).

Per row: scale s = max|x|, levels q = sign(x)·min(⌊|x|/s·L + u⌋, L) with
u ~ U[0, 1), decoded as x̂ = q·s/L, so E[x̂] = x. Wire format: a 4-byte
fp32 scale plus D entries packed at ⌈log2(2L+1)⌉ bits each (L = 15: 5
bits a coordinate, 6.4× below fp32).

``roundtrip_residual`` is one ``stochastic_quantize`` launch in its
fused mode: quantize, dequantize and the error-feedback residual in one
pass; the scale is a ``torch.amax`` outside, as in the reference.
``encode`` launches the same kernel in its q mode for the wire form
(int32 levels and the per-row scale), and ``decode`` is q·s/L.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.compress.base import (FP32_BYTES, Codec, CompressedUpdate,
                                      register_codec)
from repro_torch.kernels import ops

Tensor = torch.Tensor


@register_codec("qsgd")
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

    def encode(self, x: Tensor, noise: Optional[Tensor] = None
               ) -> CompressedUpdate:
        """{"q": int32 levels, "scale": each row's max |x|}; ``noise`` is
        one row of U[0, 1) per sender, as ``roundtrip`` takes it."""
        if noise is None:
            raise ValueError("QSGD needs one row of uniform noise per sender")
        scale = torch.amax(torch.abs(x), dim=1)
        q = ops.stochastic_quantize(x, scale, noise, levels=self.levels)
        return CompressedUpdate("qsgd", {"q": q, "scale": scale},
                                tuple(x.shape),
                                self.payload_bytes(x.shape[1]))

    def decode(self, c: CompressedUpdate) -> Tensor:
        """x̂ = q·s/L in fp32 (L a device tensor: the IEEE quotient)."""
        q, scale = c.data["q"], c.data["scale"]
        L = torch.full((), float(self.levels), dtype=torch.float32,
                       device=q.device)
        return q.to(torch.float32) * scale.reshape(-1, 1) / L

    def roundtrip_residual(self, y: Tensor, noise: Optional[Tensor] = None
                           ) -> Tuple[Tensor, Tensor]:
        if noise is None:
            raise ValueError("QSGD needs one row of uniform noise per sender")
        scale = torch.amax(torch.abs(y), dim=1)
        return ops.quantize_roundtrip(y, scale, noise, levels=self.levels)

    def roundtrip(self, x: Tensor, noise: Optional[Tensor] = None) -> Tensor:
        return self.roundtrip_residual(x, noise)[0].to(x.dtype)
