"""Checkpointable host data pipeline (port of ``repro.data.pipeline``).

The process makes its batch deterministically from (seed, step) on the
host and stages it to the device (``device.stage``: a pinned buffer and
a copy queued on the current stream, which does not block the host).
The state is one step counter, saved and restored by the checkpoint
manager, so a restart resumes the exact stream.  A small prefetch queue
makes the next batches while the device runs the step.

On a mesh each process makes only its slice of the global batch:
``global_batch // dp_total`` rows, seeded from its index on the
data-parallel axes, so the ranks of one ``model`` group draw the same
slice (the reference seeds with ``jax.process_index()``, one process a
host of many devices).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Iterator

import torch

from repro_torch.data import synthetic
from repro_torch.device import resolve_device, stage


@dataclasses.dataclass
class PipelineState:
    step: int = 0


class DataPipeline:
    """Deterministic, restartable batch source on ``device``."""

    def __init__(self, make_batch: Callable[[int, int], dict], seed: int = 0,
                 device=None, prefetch: int = 2):
        """make_batch(seed, step) -> dict of host tensors or arrays."""
        self.make_batch = make_batch
        self.seed = seed
        self.device = resolve_device(device)
        self.prefetch = max(1, prefetch)
        self.state = PipelineState()
        self._queue: collections.deque = collections.deque()
        self._pinned: list = []     # the host buffers of the batch in use

    # -- checkpointing -------------------------------------------------------
    def state_dict(self) -> dict:
        return {"step": self.state.step, "seed": self.seed}

    def load_state_dict(self, d: dict) -> None:
        self.state.step = int(d["step"])
        self.seed = int(d.get("seed", self.seed))
        self._queue.clear()

    # -- iteration -----------------------------------------------------------
    def _produce(self, step: int):
        staged, pinned = {}, []
        for key, x in self.make_batch(self.seed, step).items():
            staged[key], buf = stage(x, self.device)
            pinned.append(buf)
        return staged, pinned

    def __next__(self) -> dict:
        while len(self._queue) < self.prefetch:
            self._queue.append(self._produce(self.state.step
                                             + len(self._queue)))
        batch, self._pinned = self._queue.popleft()
        self.state.step += 1
        return batch

    def __iter__(self) -> Iterator[dict]:
        return self


def lm_pipeline(cfg, global_batch: int, seq: int, seed: int = 0,
                device=None, mesh=None, frames: bool = False) -> DataPipeline:
    """Token pipeline for an ArchConfig (adds positions / frames as its
    family needs).  ``mesh``: this process makes its dp slice of the
    global batch."""
    from repro_torch.launch.mesh import dp_index, dp_total
    n_dp = dp_total(mesh) if mesh is not None else 1
    if global_batch % n_dp:
        raise ValueError(f"a global batch of {global_batch} does not split "
                         f"over {n_dp} data-parallel ranks")
    local_batch = global_batch // n_dp
    pidx = dp_index(mesh)

    def make(s, step):
        b = synthetic.token_batch(s * 1000003 + pidx, step, local_batch, seq,
                                  cfg.vocab)
        if cfg.family == "vlm":
            b["positions"] = torch.arange(seq, dtype=torch.int32)[
                None, :, None].expand(local_batch, seq, 3).contiguous()
        if cfg.family == "encdec" or frames:
            # the reference draws the frames from (seed, step) alone, so
            # every dp slice holds the same frames
            g = synthetic._generator(s + 77, step)
            b["frames"] = torch.randn((local_batch, seq, cfg.d_model),
                                      generator=g, dtype=torch.float32)
        return b

    return DataPipeline(make, seed, device)


def cifar_pipeline(batch: int, n_classes: int = 10, seed: int = 0,
                   device=None) -> DataPipeline:
    def make(s, step):
        return synthetic.image_batch(s, step, batch, n_classes)
    return DataPipeline(make, seed, device)
