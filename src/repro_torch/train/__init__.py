"""Training (port of ``repro.train``)."""

from repro_torch.train.trainer import (TrainState, Watchdog, fit, init_state,
                                       make_train_step, resume)

__all__ = ["TrainState", "Watchdog", "fit", "init_state", "make_train_step",
           "resume"]
