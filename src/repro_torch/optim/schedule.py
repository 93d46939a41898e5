"""Learning-rate schedules (port of ``repro.optim.schedule``).

* paper_step_decay -- the paper's CIFAR recipe: 0.1 initial, /5 at epochs
  60, 120, 160 (in steps, given steps_per_epoch), 200 epochs.
* warmup_cosine -- the standard LM schedule.

Each is a function of the step (a 0-d integer tensor, as the optimizers
keep it, or an int) returning a 0-d float32 tensor on the step's device,
computed in float32 as the reference computes it: every division is a
tensor division, never a Python scalar's (CUDA divides by a scalar as a
multiply by its reciprocal).
"""

from __future__ import annotations

import math

import torch


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def paper_step_decay(base_lr: float = 0.1, steps_per_epoch: int = 391,
                     decay_epochs=(60, 120, 160), factor: float = 5.0):
    edges = [float(e * steps_per_epoch) for e in decay_epochs]

    def lr(step):
        s = _step(step)
        n = torch.sum((s >= _f32(edges, s)).to(torch.float32))
        return torch.div(_f32(base_lr, s), torch.pow(_f32(factor, s), n))

    return lr


def warmup_cosine(base_lr: float = 3e-4, warmup: int = 100,
                  total: int = 10_000, floor: float = 0.1):
    def lr(step):
        s = _step(step)
        wu = torch.clamp(torch.div(s, _f32(max(warmup, 1), s)), max=1.0)
        prog = torch.clamp(torch.div(s - warmup,
                                     _f32(max(total - warmup, 1), s)),
                           0.0, 1.0)
        cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
        return base_lr * wu * cos

    return lr


def constant(base_lr: float):
    def lr(step):
        return _f32(base_lr, torch.as_tensor(step))
    return lr
