"""Checkpointable host data pipeline (port of ``repro.data.pipeline``).

The process makes its batch deterministically from (seed, step) on the
host and stages it to the device (``device.stage``: a pinned buffer and
a copy queued on the current stream, which does not block the host).
The state is one step counter, saved and restored by the checkpoint
manager, so a restart resumes the exact stream.  A small prefetch queue
makes the next batches while the device runs the step.

One process, index 0 of 1: multi-process runs (each process its slice
of the global batch) wait for the port's launch layer.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Iterator

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
                device=None) -> DataPipeline:
    """Token pipeline for a decoder-only LM config (the reference's
    positions and frames for the VLM and encoder-decoder families wait
    for those families)."""
    if cfg.family != "lm":
        raise NotImplementedError(f"the port's lm_pipeline serves the lm "
                                  f"family, not {cfg.family!r} (ROADMAP A)")
    pidx = 0                         # process 0 of 1

    def make(s, step):
        return synthetic.token_batch(s * 1000003 + pidx, step, global_batch,
                                     seq, cfg.vocab)

    return DataPipeline(make, seed, device)


def cifar_pipeline(batch: int, n_classes: int = 10, seed: int = 0,
                   device=None) -> DataPipeline:
    def make(s, step):
        return synthetic.image_batch(s, step, batch, n_classes)
    return DataPipeline(make, seed, device)
