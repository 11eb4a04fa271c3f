"""Architecture and shape config registry (the port's copy of
``repro/configs/__init__.py``). Importing this package registers all
assigned architectures."""
from repro_torch.configs.base import (ATTN_BLOCKS, SHAPES, FLConfig,
                                      ModelConfig, ShapeConfig, get_arch,
                                      list_arches, reduced, register_arch)
# importing registers each arch (side effect)
from repro_torch.configs import (  # noqa: F401,E402
    gemma2_2b, granite_3_8b, h2o_danube_3_4b, llama4_maverick_400b_a17b,
    mistral_large_123b, mixtral_8x7b, paligemma_3b, recurrentgemma_2b,
    rwkv6_1_6b, whisper_small)

# in the reference's order
ALL_ARCH_MODULES = (
    recurrentgemma_2b,
    gemma2_2b,
    paligemma_3b,
    llama4_maverick_400b_a17b,
    mixtral_8x7b,
    whisper_small,
    h2o_danube_3_4b,
    rwkv6_1_6b,
    mistral_large_123b,
    granite_3_8b,
)

ARCH_IDS = tuple(m.CONFIG.name for m in ALL_ARCH_MODULES)

# long_500k applicability: pure full-attention archs and the
# bounded-context encoder-decoder are skipped
LONG_CONTEXT_SKIP = frozenset({
    "mistral-large-123b",
    "granite-3-8b",
    "paligemma-3b",
    "whisper-small",
})


def shape_applicable(arch: str, shape: str) -> bool:
    """Whether the ``SHAPES`` entry ``shape`` applies to ``arch``."""
    return not (shape == "long_500k" and arch in LONG_CONTEXT_SKIP)


__all__ = ["ATTN_BLOCKS", "SHAPES", "FLConfig", "ModelConfig", "ShapeConfig",
           "get_arch", "list_arches", "reduced", "register_arch", "ARCH_IDS",
           "ALL_ARCH_MODULES", "LONG_CONTEXT_SKIP", "shape_applicable"]
