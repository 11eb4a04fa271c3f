"""Mistral-Large-Instruct-2407 123B [hf:mistralai/Mistral-Large-Instruct-2407]
— dense full attention. 88L d_model=12288 96H (GQA kv=8) d_ff=28672
vocab=32768. FSDP + fused FL strategy. long_500k skipped (full attention).
The port's copy of ``repro/configs/mistral_large_123b.py``."""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="mistral-large-123b",
    family="dense",
    num_layers=88,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=32768,
    block_pattern=("A",),
    ffn_act="swiglu",
    rope_theta=1000000.0,
    fl_strategy="fused",
    fsdp=True,
    citation="hf:mistralai/Mistral-Large-Instruct-2407",
))
