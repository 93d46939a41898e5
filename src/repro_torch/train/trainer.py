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

On a mesh (``state_shardings_for``, ``shard_state``, ``jit_train_step``)
the step is the reference's SPMD contract on one process a device: the
same function as on one device.  Params and optimizer state are stored
as the sharding rules say, one local shard a rank (``step``
replicated).  Each step all-gathers every leaf to a plain full tensor
(the kernel wrappers launch on ``data_ptr()``: no distributed tensor
reaches them), takes the rank's dp slice of the batch (the pipeline
makes it), averages the gradients over the dp group in float32, clips
the average and updates only the rank's own shard.  The products are
not split over ``model``: each rank of a ``model`` group computes the
whole layer (a tensor-parallel split is later work, ROADMAP A).
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


class StepParts(NamedTuple):
    """What a train step is made of, for the mesh step to reuse."""
    cfg: Any
    loss_fn: Callable
    optimizer: Optimizer
    n_micro: int
    clip_norm: float


def _grads_and_loss(parts: StepParts, params, batch: dict):
    """The float32 gradients (``tree_leaves`` order) and the loss of
    ``batch``, each the mean over ``n_micro`` microbatches."""
    leaves = tree_leaves(params)
    for p in leaves:
        if not p.requires_grad:
            p.requires_grad_(True)
    dev = leaves[0].device
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=dev)
           for p in leaves]
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    for mb in _split_micro(batch, parts.n_micro):
        loss = parts.loss_fn(params, mb, parts.cfg)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        for a, g in zip(acc, grads):
            if g is not None:
                a.add_(g)
        loss_sum = loss_sum + loss.detach()
    n = torch.tensor(parts.n_micro, dtype=torch.float32, device=dev)
    return [a / n for a in acc], loss_sum / n


def make_train_step(cfg, mod, optimizer: Optimizer, n_micro: int = 1,
                    clip_norm: float = 1.0,
                    loss_fn: Optional[Callable] = None):
    """Returns train_step(state, batch) -> (state, metrics), which updates
    the state's tensors in place.  metrics: {"loss", "grad_norm" (before
    clipping), "step"}, device scalars.  ``jit_train_step`` makes the
    mesh step of it (``train_step.parts``)."""
    parts = StepParts(cfg, loss_fn or mod.loss_fn, optimizer, n_micro,
                      clip_norm)

    def train_step(state: TrainState, batch: dict):
        params = state.params
        grads, loss = _grads_and_loss(parts, params, batch)
        grads, gnorm = clip_by_global_norm(tree_unflatten(params, grads),
                                           clip_norm)
        new_params, new_opt = optimizer.update(grads, state.opt_state, params)
        step = state.step + 1
        return (TrainState(params=new_params, opt_state=new_opt, step=step),
                {"loss": loss, "grad_norm": gnorm, "step": step})

    train_step.parts = parts
    return train_step


# ---------------------------------------------------------------------------
# the step on a mesh
# ---------------------------------------------------------------------------

def _param_shapes(cfg, mod):
    """The model's params on the meta device: shapes and types, nothing
    drawn or allocated."""
    return mod.init_params(cfg, torch.Generator(), device="meta")


def make_shardings(cfg, mod, mesh):
    """(param shardings, the replicated sharding, batch_shardings(batch))
    of the train step on ``mesh``."""
    from repro_torch.launch.sharding import (Sharding, make_batch_shardings,
                                             make_param_shardings)
    p_shard = make_param_shardings(cfg, _param_shapes(cfg, mod), mesh,
                                   "train")
    return (p_shard, Sharding(mesh, ()),
            lambda batch: make_batch_shardings(batch, cfg, mesh))


def state_shardings_for(cfg, mod, mesh, optimizer: Optimizer) -> TrainState:
    """The ``TrainState`` of shardings: params by the rules (mode
    "train"), the optimizer's ``mu`` / ``nu`` as the params, its other
    leaves and ``step`` replicated."""
    from repro_torch.launch.sharding import Sharding, make_param_shardings
    shapes = _param_shapes(cfg, mod)
    p_shard = make_param_shardings(cfg, shapes, mesh, "train")
    repl = Sharding(mesh, ())
    opt = {k: p_shard if k in ("mu", "nu") else tree_map(lambda _: repl, v)
           for k, v in optimizer.init(shapes).items()}
    return TrainState(params=p_shard, opt_state=opt, step=repl)


def shard_state(state: TrainState, shardings: TrainState) -> TrainState:
    """Each rank's shards of a full state (every rank holds the same
    full state, e.g. from the same seed)."""
    return TrainState(
        params=tree_map(lambda x, sh: sh.shard(x), state.params,
                        shardings.params),
        opt_state=tree_map(lambda x, sh: sh.shard(x), state.opt_state,
                           shardings.opt_state),
        step=state.step)


def gather_state(state: TrainState, shardings: TrainState) -> TrainState:
    """The full state from every rank's shards (a collective)."""
    return TrainState(
        params=tree_map(lambda x, sh: sh.gather(x), state.params,
                        shardings.params),
        opt_state=tree_map(lambda x, sh: sh.gather(x), state.opt_state,
                           shardings.opt_state),
        step=state.step)


def jit_train_step(train_step, state_shardings: TrainState, mesh):
    """The step of ``make_train_step`` on ``mesh``: step(state of local
    shards, this rank's slice of the batch) -> (state, metrics), the
    same function as ``train_step`` on the global batch.  The forward
    runs under the mesh context (``mesh.activation_sharding``): the
    activations' quantization scales span the dp ranks, and the EP MoE
    layer finds its mesh."""
    from repro_torch.launch.mesh import (activation_sharding, all_reduce,
                                         dp_axes, dp_total)
    parts = train_step.parts
    p_shard = state_shardings.params
    dp, n_dp = dp_axes(mesh), dp_total(mesh)

    def step_fn(state: TrainState, batch: dict):
        full = tree_map(lambda x, sh: sh.gather(x).detach(), state.params,
                        p_shard)
        with activation_sharding(dp, n_dp, mesh=mesh):
            grads, loss = _grads_and_loss(parts, full, batch)
        n = torch.tensor(float(n_dp), dtype=torch.float32,
                         device=loss.device)
        # the dp mean in float32: a sum over the dp ranks, then / n
        grads = [torch.div(all_reduce(g, mesh, dp), n) for g in grads]
        loss = torch.div(all_reduce(loss.clone(), mesh, dp), n)
        grads, gnorm = clip_by_global_norm(tree_unflatten(full, grads),
                                           parts.clip_norm)
        local = tree_map(lambda g, sh: sh.shard(g), grads, p_shard)
        new_params, new_opt = parts.optimizer.update(local, state.opt_state,
                                                     state.params)
        step = state.step + 1
        return (TrainState(params=new_params, opt_state=new_opt, step=step),
                {"loss": loss, "grad_norm": gnorm, "step": step})

    step_fn.parts = parts
    return step_fn


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
        log_every: int = 10, log_fn=print,
        shardings: Optional[TrainState] = None) -> TrainState:
    """Run the loop: data -> step -> metrics -> checkpoint, preemption-safe
    (a SIGTERM checkpoints after the running step and stops).  On a mesh
    ``shardings`` (``state_shardings_for``) says how the state's leaves
    are split: a checkpoint gathers them."""
    preempted = {"flag": False}
    sh = shardings or TrainState(None, None, None)

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
                                 "step": i + 1},
                          shardings=sh.params, opt_shardings=sh.opt_state)
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
           device=None, mesh=None) -> Optional[TrainState]:
    """Restore the latest checkpoint of ``ckpt_dir`` (and the pipeline's
    position) on ``device``; None if there is none.  The templates are
    the model's params and the optimizer's state on the meta device
    (nothing drawn).  With ``mesh`` (of any shape: the elastic restore)
    each leaf is this rank's shard (``state_shardings_for``)."""
    step = ckpt.latest_step(ckpt_dir)
    if step is None:
        return None
    shapes = _param_shapes(cfg, mod)
    sh = (state_shardings_for(cfg, mod, mesh, optimizer) if mesh is not None
          else TrainState(None, None, None))
    params, opt_state, extra = ckpt.restore(
        ckpt_dir, step, shapes, optimizer.init(shapes), device=device,
        shardings=sh.params, opt_shardings=sh.opt_state)
    if pipeline is not None and "pipeline" in extra:
        pipeline.load_state_dict(extra["pipeline"])
    return TrainState(params=params, opt_state=opt_state,
                      step=torch.tensor(step, dtype=torch.int32,
                                        device=resolve_device(device)))
