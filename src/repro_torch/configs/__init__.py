from repro_torch.configs.base import (ATTN_BLOCKS, FLConfig, ModelConfig,
                                      get_arch, reduced, register_arch)
# importing registers the ported architectures (side effect)
from repro_torch.configs import recurrentgemma_2b  # noqa: F401,E402

__all__ = ["ATTN_BLOCKS", "FLConfig", "ModelConfig", "get_arch", "reduced",
           "register_arch"]
