"""Mixtral-8x7B [arXiv:2401.04088] — MoE 8 experts top-2, sliding-window
attention. 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.
FSDP + fused FL strategy (47B params).
The port's copy of ``repro/configs/mixtral_8x7b.py``."""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="mixtral-8x7b",
    family="moe",
    num_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    block_pattern=("L",),
    window=4096,
    n_experts=8,
    top_k=2,
    ffn_act="swiglu",
    rope_theta=1000000.0,
    fl_strategy="fused",
    fsdp=True,
    citation="arXiv:2401.04088",
))
