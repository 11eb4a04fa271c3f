"""The model zoo's serving path (the port's counterpart of
``repro.models``): ``recurrentgemma-2b``'s RG-LRU and local-attention
blocks with dense GeGLU FFNs."""
from repro_torch.models.model import Model, build_model

__all__ = ["Model", "build_model"]
