"""Optimizers and schedules (port of ``repro.optim``).  The quantized
gradient all-reduce (``grad_compress``) waits for the port's launch
layer (ROADMAP A11)."""

from repro_torch.optim.optimizers import (Optimizer, adamw,
                                          clip_by_global_norm, global_norm,
                                          sgd_nesterov,
                                          tree_leaves, tree_map,
                                          tree_unflatten)
from repro_torch.optim.schedule import (constant, paper_step_decay,
                                        warmup_cosine)

__all__ = ["Optimizer", "adamw", "clip_by_global_norm", "global_norm",
           "sgd_nesterov",
           "tree_leaves", "tree_map", "tree_unflatten", "constant",
           "paper_step_decay", "warmup_cosine"]
