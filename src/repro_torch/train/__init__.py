from repro_torch.train.steps import make_plain_step

__all__ = ["make_plain_step"]
