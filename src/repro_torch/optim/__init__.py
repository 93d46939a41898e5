"""Optimizers, schedules and the int8 error-feedback gradient
all-reduce (port of ``repro.optim``)."""

from repro_torch.optim.optimizers import (Optimizer, adamw,
                                          clip_by_global_norm, global_norm,
                                          sgd_nesterov,
                                          tree_leaves, tree_map,
                                          tree_unflatten)
from repro_torch.optim.schedule import (constant, paper_step_decay,
                                        warmup_cosine)
from repro_torch.optim import grad_compress

__all__ = ["Optimizer", "adamw", "clip_by_global_norm", "global_norm",
           "sgd_nesterov",
           "tree_leaves", "tree_map", "tree_unflatten", "constant",
           "paper_step_decay", "warmup_cosine", "grad_compress"]
