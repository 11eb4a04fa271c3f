"""RecurrentGemma-2B [arXiv:2402.19427] — Griffin-style hybrid:
RG-LRU recurrent blocks + local attention in a 1:2 ratio
(pattern: recurrent, recurrent, local-attn). 26L d_model=2560 10H
(GQA kv=1, MQA) d_ff=7680 vocab=256000, window 2048. The port's copy of
``repro/configs/recurrentgemma_2b.py``."""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=("R", "R", "L"),
    window=2048,
    rg_lru_dim=2560,
    ffn_act="geglu",
    emb_scale=True,
    logit_softcap=30.0,
    fl_strategy="two_phase",
    citation="arXiv:2402.19427",
))
