"""The model zoo (the port's counterpart of ``repro.models``) for
decoder-only models: attention (global, sliding-window, chunked), RG-LRU
and RWKV6 mixers; dense, MoE and RWKV channel-mix FFNs."""
from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
