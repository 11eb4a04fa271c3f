"""H2O-Danube3-4B [arXiv:2401.16818] — llama+mistral mix, sliding-window
attention. 24L d_model=3840 32H (GQA kv=8) d_ff=10240 vocab=32000.
The port's copy of ``repro/configs/h2o_danube_3_4b.py``."""
from repro_torch.configs.base import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="h2o-danube-3-4b",
    family="dense",
    num_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    head_dim=120,
    d_ff=10240,
    vocab_size=32000,
    block_pattern=("L",),
    window=4096,
    ffn_act="swiglu",
    fl_strategy="two_phase",
    citation="arXiv:2401.16818",
))
