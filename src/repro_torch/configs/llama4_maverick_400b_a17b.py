"""Llama-4 Maverick 400B-A17B [hf:meta-llama/Llama-4-Scout-17B-16E family]
— MoE 128 experts top-1, early-fusion, iRoPE-style chunked attention with
periodic global (NoPE) layers. 48L d_model=5120 40H (GQA kv=8) expert
d_ff=8192 vocab=202048. FSDP + fused FL strategy (400B params).
The port's copy of ``repro/configs/llama4_maverick_400b_a17b.py``; like
the reference's attention, the port applies RoPE on the global "A"
layers too."""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    block_pattern=("C", "C", "C", "A"),
    chunk=8192,
    n_experts=128,
    moe_every=2,              # MoE interleaved with dense layers (Maverick)
    top_k=1,
    ffn_act="swiglu",
    rope_theta=500000.0,
    fl_strategy="fused",
    fsdp=True,
    citation="hf:meta-llama/Llama-4-Scout-17B-16E",
))
