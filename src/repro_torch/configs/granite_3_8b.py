"""Granite-3.0 8B [hf:ibm-granite/granite-3.0-2b-base family] — dense GQA.
40L d_model=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.
long_500k skipped (full attention).
The port's copy of ``repro/configs/granite_3_8b.py``."""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="granite-3-8b",
    family="dense",
    num_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=12800,
    vocab_size=49155,
    block_pattern=("A",),
    ffn_act="swiglu",
    fl_strategy="two_phase",
    citation="hf:ibm-granite/granite-3.0-2b-base",
))
