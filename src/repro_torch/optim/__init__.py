"""Optimizers over parameter trees (client-stacked in the engine)."""
from repro_torch.optim.optimizers import (Optimizer, adamw, apply_updates,
                                          clip_by_global_norm, sgd)

__all__ = ["Optimizer", "adamw", "apply_updates", "clip_by_global_norm",
           "sgd"]
