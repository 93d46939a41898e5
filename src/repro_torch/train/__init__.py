"""Training (port of ``repro.train``)."""

from repro_torch.train.trainer import (TrainState, Watchdog, fit,
                                       gather_state, init_state,
                                       jit_train_step, make_shardings,
                                       make_train_step, resume, shard_state,
                                       state_shardings_for)

__all__ = ["TrainState", "Watchdog", "fit", "gather_state", "init_state",
           "jit_train_step", "make_shardings", "make_train_step", "resume",
           "shard_state", "state_shardings_for"]
