"""Cost-aware gradient compression for the multi-cloud hierarchy:
``topk`` (error-feedback sparsification through the ``topk_mask``
kernel) and ``none`` (fp32 passthrough), assigned per link class by a
``LinkPolicy``. ``qsgd`` comes with a later slice."""
from repro_torch.compress.base import Codec, ef_step_masked
from repro_torch.compress.policy import (POLICIES, LinkPolicy,
                                         build_link_policy, make_codec)
from repro_torch.compress.topk import TopKCodec

__all__ = ["Codec", "ef_step_masked", "make_codec", "POLICIES",
           "LinkPolicy", "build_link_policy", "TopKCodec"]
