from repro_torch.configs.base import (ATTN_BLOCKS, SHAPES, FLConfig,
                                      ModelConfig, ShapeConfig, get_arch,
                                      reduced, register_arch)
# importing registers the ported architectures (side effect)
from repro_torch.configs import (  # noqa: F401,E402
    gemma2_2b, granite_3_8b, h2o_danube_3_4b, llama4_maverick_400b_a17b,
    mistral_large_123b, mixtral_8x7b, paligemma_3b, recurrentgemma_2b,
    rwkv6_1_6b, whisper_small)

__all__ = ["ATTN_BLOCKS", "SHAPES", "FLConfig", "ModelConfig", "ShapeConfig",
           "get_arch", "reduced", "register_arch"]
