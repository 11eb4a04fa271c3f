"""Cost-aware gradient compression for the multi-cloud hierarchy:
``topk`` (error-feedback sparsification through the ``topk_mask``
kernel), ``qsgd`` (unbiased stochastic quantization through the
``stochastic_quantize`` kernel) and ``none`` (fp32 passthrough),
assigned per link class by a ``LinkPolicy``. ``Codec.encode``/``decode``
give the structured wire form (``CompressedUpdate``); ``register_codec``
adds a codec ``make_codec`` can build."""
from repro_torch.compress.base import (Codec, CompressedUpdate, ef_step,
                                       ef_step_masked, make_codec,
                                       register_codec)
from repro_torch.compress.policy import (POLICIES, LinkPolicy,
                                         build_link_policy,
                                         policy_from_flcfg)
from repro_torch.compress.qsgd import QSGDCodec
from repro_torch.compress.topk import TopKCodec

__all__ = ["Codec", "CompressedUpdate", "ef_step", "ef_step_masked",
           "make_codec", "register_codec", "POLICIES", "LinkPolicy",
           "build_link_policy", "policy_from_flcfg", "QSGDCodec",
           "TopKCodec"]
