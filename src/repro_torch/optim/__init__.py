"""Optimizers over parameter trees (client-stacked in the engine) and
learning-rate schedules."""
from repro_torch.optim.optimizers import (Optimizer, Schedule, adamw,
                                          apply_updates,
                                          clip_by_global_norm, sgd)
from repro_torch.optim.schedule import (constant, cosine_decay,
                                        linear_warmup_cosine)

__all__ = ["Optimizer", "Schedule", "adamw", "apply_updates",
           "clip_by_global_norm", "constant", "cosine_decay",
           "linear_warmup_cosine", "sgd"]
