"""Public model API: ``Model(cfg)`` bundles init / prefill / decode (the
port's copy of the serving parts of ``repro/models/model.py``; ``loss``
and ``grad_fn`` wait for the training slice). Parameters and caches are
plain dicts of tensors; ``Model`` only carries the static config."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple, Union

import torch

from repro_torch.configs.base import ModelConfig, get_arch, reduced
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import transformer as tfm
from repro_torch.models.common import softcap

Tensor = torch.Tensor
Params = Dict[str, Any]
DTypeLike = Union[str, torch.dtype]


def as_dtype(dtype: DTypeLike) -> torch.dtype:
    """``torch.float32`` from ``torch.float32`` or ``"float32"``."""
    if isinstance(dtype, torch.dtype):
        return dtype
    dt = getattr(torch, str(dtype), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return dt


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    # -- init ---------------------------------------------------------------
    def init(self, seed: int = 0, *, device: DeviceLike = "cuda",
             dtype: DTypeLike = torch.float32) -> Params:
        """Random weights from a ``torch.Generator`` on ``device`` seeded
        with ``seed``; raises on ``"cuda"`` without a GPU."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return tfm.init_params(gen, self.cfg, as_dtype(dtype))

    # -- serving ------------------------------------------------------------
    def init_cache(self, params: Params, batch: int, max_len: int
                   ) -> Params:
        """An empty decode cache in the weights' dtype."""
        return tfm.init_cache(params, self.cfg, batch, max_len)

    def prefill(self, params: Params, batch: Dict[str, Tensor],
                max_len: int) -> Tuple[Tensor, Params]:
        """Run the prompt through one full-sequence forward and fill a
        cache. Returns (last logits (B, V), cache), the same as the
        reference's ``Model.prefill`` (T decode steps); the cache is in
        the weights' dtype (the reference's ``cache_dtype`` option is not
        kept: decode computes in one dtype)."""
        tokens = batch["tokens"]
        if tokens.shape[1] > max_len:
            raise ValueError(f"prompt of {tokens.shape[1]} tokens does not "
                             f"fit max_len {max_len}")
        h, cache = tfm.prefill_hidden(params, self.cfg, tokens, max_len)
        logits = tfm.logits_fn(params, self.cfg, h[:, -1:])[:, 0]
        return softcap(logits, self.cfg.logit_softcap), cache

    def decode_step(self, params: Params, cache: Params, token: Tensor,
                    index: int) -> Tuple[Tensor, Params]:
        return tfm.decode_step(params, self.cfg, cache, token, index)

    # -- helpers ------------------------------------------------------------
    def dummy_batch(self, seed: int, batch: int, seq: int, *,
                    device: DeviceLike = "cpu") -> Dict[str, Tensor]:
        """Random prompt tokens from a CPU ``torch.Generator`` seeded with
        ``seed``, so the same seed gives the same tokens on every device
        (the labels and mask of the reference's batch come with
        training)."""
        gen = torch.Generator()
        gen.manual_seed(seed)
        tokens = torch.randint(0, self.cfg.vocab_size, (batch, seq),
                               generator=gen)
        return {"tokens": tokens.to(torch.device(device))}


def build_model(arch: str, smoke: bool = False) -> Model:
    cfg = get_arch(arch)
    if smoke:
        cfg = reduced(cfg)
    return Model(cfg)
