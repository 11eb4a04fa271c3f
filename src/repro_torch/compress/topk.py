"""Top-k sparsification codec (error feedback applied by the caller).

Wire format per update: a 4-byte length header, then k (value, index)
pairs — fp16 value + int32 index — so the exact payload is ``4 + 6k``
bytes against ``4D`` uncompressed.

``roundtrip`` keeps each row's k largest-magnitude entries (ties at the
threshold kept) and passes them through fp16, in one ``topk_mask``
kernel launch with the fp16 round trip fused.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.compress.base import Codec
from repro_torch.kernels import ops

_HEADER_BYTES = 4      # entry count
_VALUE_BYTES = 2       # fp16 value
_INDEX_BYTES = 4       # int32 position


@dataclass(frozen=True)
class TopKCodec(Codec):
    """Keep the ``ratio`` fraction of largest-magnitude entries per row."""
    ratio: float = 0.1
    name = "topk"

    @property
    def is_identity(self) -> bool:
        return self.ratio >= 1.0

    def k_for(self, d: int) -> int:
        return max(1, min(d, int(round(self.ratio * d))))

    def payload_bytes(self, d: int) -> int:
        if self.is_identity:
            return super().payload_bytes(d)
        return _HEADER_BYTES + self.k_for(d) * (_VALUE_BYTES + _INDEX_BYTES)

    def roundtrip(self, x: torch.Tensor) -> torch.Tensor:
        if self.is_identity:
            return x
        thr = ops.row_threshold(x, self.k_for(x.shape[1]))
        # the fp16 wire precision of the values, fused into the mask
        return ops.topk_mask(x, thr, fp16_roundtrip=True)
