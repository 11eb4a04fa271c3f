"""The model zoo (the port's counterpart of ``repro.models``): attention
(global, sliding-window, chunked, a bidirectional prefix,
cross-attention), RG-LRU and RWKV6 mixers; dense, MoE and RWKV
channel-mix FFNs; an audio encoder; the stub modality frontends."""
from repro_torch.models.model import Model, build_model
from repro_torch.models.frontends import batch_spec, make_batch

__all__ = ["Model", "build_model", "batch_spec", "make_batch"]
