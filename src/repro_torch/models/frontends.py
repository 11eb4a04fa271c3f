"""Modality frontend STUBS (the port's copy of
``repro/models/frontends.py``): a VLM's ``patches`` and an audio
encoder-decoder's ``frames`` are precomputed embeddings of the right
shape, drawn at random, in place of a ViT or a conv codec."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike

Tensor = torch.Tensor


def batch_spec(cfg: ModelConfig, shape: ShapeConfig, dtype=torch.bfloat16
               ) -> Dict[str, Tensor]:
    """Stand-ins on the ``meta`` device (no storage) for every model input
    of a *training or prefill* batch. Text length shrinks by the vision
    prefix so the total sequence is ``shape.seq_len``."""
    b, s = shape.global_batch, shape.seq_len
    text = s - cfg.vis_tokens if cfg.vis_tokens else s

    def meta(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")
    spec = {"tokens": meta((b, text), torch.int32),
            "labels": meta((b, text), torch.int32),
            "mask": meta((b, text), torch.float32)}
    if cfg.vis_tokens:
        spec["patches"] = meta((b, cfg.vis_tokens, cfg.d_model), dtype)
    if cfg.is_encdec:
        spec["frames"] = meta((b, cfg.enc_frames, cfg.d_model), dtype)
    return spec


def make_batch(seed: int, cfg: ModelConfig, batch: int, seq: int,
               dtype=torch.float32, *, device: DeviceLike = "cpu"
               ) -> Dict[str, Tensor]:
    """A random batch matching :func:`batch_spec`, drawn from a CPU
    ``torch.Generator`` seeded with ``seed`` (the same batch on every
    device), then moved to ``device``: ``seq`` - ``vis_tokens`` text
    tokens, the reference's labels (the tokens shifted left, 0 last) and
    mask (1, the last position 0), then 0.02·N(0, 1) patches and frames
    in ``dtype`` where the model takes them."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    text = seq - cfg.vis_tokens if cfg.vis_tokens else seq
    tokens = torch.randint(0, cfg.vocab_size, (batch, text), generator=gen)
    labels = torch.cat([tokens[:, 1:], torch.zeros_like(tokens[:, :1])],
                       dim=1)
    mask = torch.ones(batch, text)
    mask[:, -1] = 0.0
    out = {"tokens": tokens, "labels": labels, "mask": mask}
    if cfg.vis_tokens:
        out["patches"] = 0.02 * torch.randn(
            (batch, cfg.vis_tokens, cfg.d_model), generator=gen)
    if cfg.is_encdec:
        out["frames"] = 0.02 * torch.randn(
            (batch, cfg.enc_frames, cfg.d_model), generator=gen)
    dev = torch.device(device)
    return {k: v.to(dev, dtype if v.is_floating_point() and k != "mask"
                    else v.dtype) for k, v in out.items()}
