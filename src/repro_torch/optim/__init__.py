from repro_torch.optim.optimizers import (OPTIMIZERS, OptState, adamw,
                                          clip_by_global_norm,
                                          cosine_schedule, sgd)

__all__ = ["OPTIMIZERS", "OptState", "adamw", "clip_by_global_norm",
           "cosine_schedule", "sgd"]
