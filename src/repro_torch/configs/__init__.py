from repro_torch.configs.base import (ATTN_BLOCKS, FLConfig, ModelConfig,
                                      get_arch, reduced, register_arch)
# importing registers the ported architectures (side effect)
from repro_torch.configs import (  # noqa: F401,E402
    gemma2_2b, granite_3_8b, h2o_danube_3_4b, mistral_large_123b,
    recurrentgemma_2b)

__all__ = ["ATTN_BLOCKS", "FLConfig", "ModelConfig", "get_arch", "reduced",
           "register_arch"]
