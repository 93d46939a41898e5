"""The training loop (port of ``repro.train.trainer``): microbatch
accumulation, global-norm clipping, the optimizer, and fault tolerance.

One train step:

  1. split the batch into ``n_micro`` microbatches;
  2. for each, the loss and its gradients (``torch.autograd.grad``), the
     gradients summed in float32 in microbatch order, then divided by
     ``n_micro`` (the loss likewise);
  3. global-norm clipping, then the optimizer's in-place update.

The reference jits the step and donates its state; the port runs it
eagerly and updates params and optimizer state in place (the returned
state holds the same tensors).  No host sync inside the step: its
metrics are device scalars, and ``fit`` fetches the previous step's only
at ``log_every``.  ``fit`` has the reference's per-step watchdog,
checkpoint cadence (with the data pipeline's state) and SIGTERM
handler.  The reference rematerializes each layer inside its scan; the
port keeps the activations (no value changes).

The reference's mesh functions (``make_shardings``, ``jit_train_step``,
``state_shardings_for``) and the quantized gradient all-reduce wait for
the port's launch layer (ROADMAP A11).
"""

from __future__ import annotations

import signal
import time
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.checkpoint import manager as ckpt
from repro_torch.device import resolve_device
from repro_torch.optim.optimizers import (Optimizer, clip_by_global_norm,
                                          tree_leaves, tree_map,
                                          tree_unflatten)


class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor      # 0-d int32, on the params' device


def init_state(cfg, mod, optimizer: Optimizer, gen: torch.Generator,
               device=None) -> TrainState:
    """Fresh params drawn from ``gen`` (``mod.init_params``) on ``device``
    (default: the CUDA card), the optimizer's state, step 0."""
    device = resolve_device(device)
    params = mod.init_params(cfg, gen, device=device)
    return TrainState(params=params, opt_state=optimizer.init(params),
                      step=torch.zeros((), dtype=torch.int32, device=device))


def _split_micro(batch: dict, n_micro: int) -> list:
    def split(x):
        b = x.shape[0]
        if b % n_micro:
            raise ValueError(f"a batch of {b} does not split into {n_micro} "
                             f"microbatches")
        return x.reshape(n_micro, b // n_micro, *x.shape[1:])

    parts = {k: split(v) for k, v in batch.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n_micro)]


def make_train_step(cfg, mod, optimizer: Optimizer, n_micro: int = 1,
                    clip_norm: float = 1.0,
                    loss_fn: Optional[Callable] = None):
    """Returns train_step(state, batch) -> (state, metrics), which updates
    the state's tensors in place.  metrics: {"loss", "grad_norm" (before
    clipping), "step"}, device scalars."""
    loss_fn = loss_fn or mod.loss_fn

    def train_step(state: TrainState, batch: dict):
        params = state.params
        leaves = tree_leaves(params)
        for p in leaves:
            if not p.requires_grad:
                p.requires_grad_(True)
        dev = leaves[0].device
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
               for p in leaves]
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for mb in _split_micro(batch, n_micro):
            loss = loss_fn(params, mb, cfg)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            for a, g in zip(acc, grads):
                if g is not None:
                    a.add_(g)
            loss_sum = loss_sum + loss.detach()
        n = torch.tensor(n_micro, dtype=torch.float32, device=dev)
        grads = tree_unflatten(params, [a / n for a in acc])
        loss = loss_sum / n
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        new_params, new_opt = optimizer.update(grads, state.opt_state, params)
        step = state.step + 1
        return (TrainState(params=new_params, opt_state=new_opt, step=step),
                {"loss": loss, "grad_norm": gnorm, "step": step})

    return train_step


# ---------------------------------------------------------------------------
# host-side fit loop with fault tolerance
# ---------------------------------------------------------------------------

class Watchdog:
    """Flags steps slower than ``factor`` x the running median (stragglers)."""

    def __init__(self, factor: float = 3.0):
        self.factor = factor
        self.times = []
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        self.times.append(dt)
        hist = sorted(self.times[-50:])
        med = hist[len(hist) // 2]
        slow = len(self.times) > 5 and dt > self.factor * med
        self.flagged += int(slow)
        return slow


def _wait(t: torch.Tensor) -> None:
    """Block until the device has computed ``t``."""
    if t.device.type == "cuda":
        torch.cuda.current_stream(t.device).synchronize()


def fit(state: TrainState, train_step, pipeline, steps: int,
        ckpt_dir: Optional[str] = None, ckpt_every: int = 100,
        log_every: int = 10, log_fn=print) -> TrainState:
    """Run the loop: data -> step -> metrics -> checkpoint, preemption-safe
    (a SIGTERM checkpoints after the running step and stops)."""
    preempted = {"flag": False}

    def _on_signal(signum, frame):
        preempted["flag"] = True

    previous = None
    try:
        previous = signal.signal(signal.SIGTERM, _on_signal)
    except ValueError:
        pass  # not on the main thread (tests)

    try:
        watchdog = Watchdog()
        pending = None
        for i in range(int(state.step), steps):
            batch = next(pipeline)
            t0 = time.perf_counter()
            state, metrics = train_step(state, batch)
            if pending is not None and i % log_every == 0:
                m = {k: v.item() for k, v in pending.items()}  # the PREVIOUS step's
                log_fn(f"step {int(m['step']):6d} loss {m['loss']:.4f} "
                       f"gnorm {m['grad_norm']:.3f}")
            pending = metrics
            _wait(state.step)
            dt = time.perf_counter() - t0
            if watchdog.observe(dt):
                log_fn(f"[watchdog] slow step {i}: {dt:.2f}s")
            if ckpt_dir and ((i + 1) % ckpt_every == 0 or preempted["flag"]):
                ckpt.save(ckpt_dir, i + 1, state.params, state.opt_state,
                          extra={"pipeline": pipeline.state_dict(),
                                 "step": i + 1})
            if preempted["flag"]:
                log_fn(f"[preempt] checkpointed at step {i + 1}, exiting")
                break
        if pending is not None:
            m = {k: v.item() for k, v in pending.items()}
            log_fn(f"final step {int(m['step'])} loss {m['loss']:.4f}")
    finally:
        if previous is not None:
            signal.signal(signal.SIGTERM, previous)
    return state


def resume(cfg, mod, optimizer: Optimizer, ckpt_dir: str, pipeline=None,
           device=None) -> Optional[TrainState]:
    """Restore the latest checkpoint of ``ckpt_dir`` (and the pipeline's
    position) on ``device``; None if there is none.  The templates are
    the model's params and the optimizer's state on the meta device."""
    step = ckpt.latest_step(ckpt_dir)
    if step is None:
        return None
    shapes = tree_map(lambda t: torch.empty_like(t, device="meta"),
                      mod.init_params(cfg, torch.Generator(), device="cpu"))
    params, opt_state, extra = ckpt.restore(
        ckpt_dir, step, shapes, optimizer.init(shapes), device=device)
    if pipeline is not None and "pipeline" in extra:
        pipeline.load_state_dict(extra["pipeline"])
    return TrainState(params=params, opt_state=opt_state,
                      step=torch.tensor(step, dtype=torch.int32,
                                        device=resolve_device(device)))
