"""RWKV-6 "Finch" 1.6B [arXiv:2404.05892] — attention-free SSM with
data-dependent decay time-mix. 24L d_model=2048 d_ff=7168 vocab=65536.
Decode state is O(1); long_500k natural fit.
The port's copy of ``repro/configs/rwkv6_1_6b.py``."""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    n_heads=32,               # time-mix heads (head_dim 64)
    n_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    block_pattern=("W",),
    ffn_act="gelu",           # rwkv channel-mix (squared relu approx by gelu path)
    rope_theta=0.0,
    tie_embeddings=False,
    fl_strategy="two_phase",
    citation="arXiv:2404.05892",
))
