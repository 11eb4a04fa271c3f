"""PaliGemma-3B [arXiv:2407.07726] — VLM: SigLIP vision encoder (STUB —
input_specs provides 256 precomputed patch embeddings) + Gemma decoder
backbone. 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=257216.
The port's copy of ``repro/configs/paligemma_3b.py``."""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    block_pattern=("A",),
    vis_tokens=256,
    ffn_act="geglu",
    emb_scale=True,
    fl_strategy="two_phase",
    citation="arXiv:2407.07726",
))
