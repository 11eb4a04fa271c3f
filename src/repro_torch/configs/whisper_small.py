"""Whisper-small [arXiv:2212.04356] — encoder-decoder; mel+conv frontend
is a STUB (input_specs provides 1500 precomputed frame embeddings).
12L enc + 12L dec, d_model=768 12H (MHA kv=12) d_ff=3072 vocab=51865.
The port's copy of ``repro/configs/whisper_small.py``."""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,
    enc_layers=12,
    enc_frames=1500,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    block_pattern=("A",),
    ffn_act="gelu",
    rope_theta=0.0,        # learned absolute positions
    tie_embeddings=True,
    fl_strategy="two_phase",
    citation="arXiv:2212.04356",
))
