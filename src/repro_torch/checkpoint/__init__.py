"""Checkpoints (port of ``repro.checkpoint``): the trainer's ``save`` /
``restore`` and the template-free state functions the sweeps use."""

from repro_torch.checkpoint import manager
from repro_torch.checkpoint.manager import (all_steps, latest_step,
                                            load_state, restore, save,
                                            save_state)

__all__ = ["manager", "all_steps", "latest_step", "load_state", "restore",
           "save", "save_state"]
