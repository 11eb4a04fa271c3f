"""Gemma-2 2B [arXiv:2408.00118] — dense, alternating local/global
attention, attention + final-logit soft-capping, GQA kv=4.
26L d_model=2304 8H d_ff=9216 vocab=256000, window 4096.
The port's copy of ``repro/configs/gemma2_2b.py``."""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="gemma2-2b",
    family="dense",
    num_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    block_pattern=("L", "A"),
    window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    ffn_act="geglu",
    emb_scale=True,
    fl_strategy="two_phase",
    citation="arXiv:2408.00118",
))
