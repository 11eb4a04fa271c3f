from repro_torch.configs.base import FLConfig

__all__ = ["FLConfig"]
