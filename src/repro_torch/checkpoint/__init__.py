"""Checkpoints (port of ``repro.checkpoint``): the template-free state
functions the sweeps use.  The training ``save`` / ``restore`` wait for
the port's trainer."""

from repro_torch.checkpoint import manager
from repro_torch.checkpoint.manager import (all_steps, latest_step,
                                            load_state, save_state)

__all__ = ["manager", "all_steps", "latest_step", "load_state", "save_state"]
