"""PyTorch/CUDA port of the Cost-TrustFL reproduction.

Mirrors the layout of the JAX package ``repro`` module for module
(``repro_torch.federated.engine`` is the counterpart of
``repro.federated.engine``), imports neither JAX nor ``repro``, and runs
its hot path through CUDA kernels written for Hopper
(``repro_torch.kernels``). Public entry points run on ``device="cuda"``
unless the caller passes ``device="cpu"``.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
