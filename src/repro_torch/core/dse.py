"""Design-space exploration + Pareto analysis (port of ``repro.core.dse``;
the paper's Sec. IV).

Every design point of a batched config is priced against a workload:
the cost-model backend's PPA stage gives each lane its clock and area,
the dataflow fold sums the per-layer row-stationary costs at that clock,
and ``_finish`` derives the paper's metrics (perf/area, energy per
inference) on the host in float64.  Both device stages are eager torch
on the device of the config.

Batches are processed in fixed-shape chunks (the trailing partial chunk
repeats its last point up to the chunk shape), as in the reference; every
per-lane computation is elementwise, so a lane's result does not depend
on the chunk it was evaluated in.  That is what the three bitwise
contracts of the joint walk rest on:

* padded layers are inert: ``reduce_layer_costs`` masks ``count == 0``
  rows to exact 0.0 and folds layers strictly in order;
* mixed-model lanes equal per-model lanes: a mixed chunk gathers each
  lane's (L,) layer stack from a ``StackedWorkload`` into (lanes, L)
  fields and runs the same ``layer_cost`` ops as the broadcast (1, L)
  per-model path;
* the two-stage walk equals the single-stage one: ``TwoStagePruner``
  passes stage 1's clock, area and leakage (float32, through the host)
  to stage 2 instead of recomputing them, at the same chunk shape.

The streaming half walks a space lazily (``evaluate_space_streaming``),
folds every chunk into a non-dominated ``ParetoArchive`` and applies
deployment budgets (``constraints``), two-stage when the budget has
config-stage bounds.  The walk runs on the device of the workload; its
chunks are decoded on the host and each goes to the device with its
evaluation (``dispatch_chunk``), so a sharded walk can keep a chunk's
whole work on its shard's stream (``repro_torch.core.shard``).

Asynchrony on a card: ``dispatch_chunk`` uploads a chunk's configs from
a pinned buffer, queues both stages and the copy of the sums into a
pinned host buffer on the current stream, and records an event after
it; ``finish_chunk`` waits on that event only.  So the host is free from
dispatch to finish (a pageable copy would have waited for the stream).

Telemetry (``telemetry=``, a ``repro_torch.obs.Tracer``) keeps the
reference's spans and counters: ``decode``, ``dispatch``,
``device_wait``, ``archive``, ``prune_stage1`` / ``prune_stage2``;
``sweep.points``, ``budget.killed``, ``budget.kill.<constraint>``,
``prune.flushes`` and the ``prune.buffered`` gauge.  The reference's
compile counters (``trace_count``, ``compile.L<n>``, ``sweep.compiles``)
count XLA traces; eager torch compiles nothing, so the port emits none.
"""

from __future__ import annotations

from typing import Iterator, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.arch import (AcceleratorConfig, PE_INT16, PE_TYPE_NAMES,
                                   concat_configs, iter_space_chunks,
                                   space_points, take_config)
from repro_torch.core.constraints import (Budget, BudgetStats, apply_budget,
                                          mask_result)
from repro_torch.core.costmodel import CostModel, as_cost_model
from repro_torch.core.dataflow import LayerCost, layer_cost, reduce_layer_costs
from repro_torch.core.ppa import PPAModels
from repro_torch.core.synth import LEAKAGE_MW_PER_MM2
from repro_torch.core.arch import config_to
from repro_torch.core.workloads import LayerSpec, StackedWorkload, Workload
from repro_torch.device import host, stage
from repro_torch.obs import as_tracer, timed_iter

# Default number of design points evaluated per chunk.
DEFAULT_CHUNK_SIZE = 4096

# Host dtype of every DseResult column: the derived metrics are computed
# on the host in float64 from the device sums (macs overflows float32's
# mantissa for ImageNet-scale networks).
RESULT_DTYPES = dict.fromkeys((
    "latency_s", "energy_j", "energy_total_j", "area_mm2", "power_mw",
    "clock_ghz", "perf", "perf_per_area", "utilization", "macs"), np.float64)


class DseResult(NamedTuple):
    """Struct-of-arrays over N design points for one workload (host
    float64 numpy columns)."""
    latency_s: np.ndarray
    energy_j: np.ndarray         # chip energy: MAC + on-chip mem + leakage*T
    energy_total_j: np.ndarray   # chip + DRAM (beyond-paper reporting)
    area_mm2: np.ndarray
    power_mw: np.ndarray
    clock_ghz: np.ndarray
    perf: np.ndarray             # inferences / s
    perf_per_area: np.ndarray    # inferences / s / mm^2
    utilization: np.ndarray
    macs: np.ndarray


def _ppa_stage(ppa_fn, params, cfg: AcceleratorConfig):
    """The PPA stage: the backend's (power, clock, area) plus leakage from
    area at the shared 45 nm density."""
    power_mw, clock_ghz, area_mm2 = ppa_fn(params, cfg)
    return power_mw, clock_ghz, area_mm2, LEAKAGE_MW_PER_MM2 * area_mm2


def _network_sums(cfg: AcceleratorConfig, clock_ghz: torch.Tensor,
                  layers: LayerSpec) -> LayerCost:
    """Summed network cost per design-point lane: (lanes, 1) configs
    against (1, L) layers, then the masked sequential layer fold."""
    lanes = AcceleratorConfig(*[f[:, None] for f in cfg])
    per_layer = layer_cost(LayerSpec(*[f[None, :] for f in layers]),
                           lanes, clock_ghz[:, None])
    return reduce_layer_costs(per_layer, layers.count)


def _network_sums_mixed(cfg: AcceleratorConfig, clock_ghz: torch.Tensor,
                        stacked_layers: LayerSpec,
                        model_ids: torch.Tensor) -> LayerCost:
    """Model-lane evaluation: each lane gathers its own layer stack from
    the (M, L) fields, giving (lanes, L) layers that go through exactly
    the ops of the broadcast (1, L) path."""
    lane_layers = LayerSpec(*[f[model_ids] for f in stacked_layers])
    lanes = AcceleratorConfig(*[f[:, None] for f in cfg])
    per_layer = layer_cost(lane_layers, lanes, clock_ghz[:, None])
    return reduce_layer_costs(per_layer, lane_layers.count)


def _network_stage(cfg: AcceleratorConfig, clock_ghz,
                   workload: Workload | StackedWorkload, model_ids=None):
    """The dataflow stage of one chunk (``model_ids``: a mixed chunk)."""
    if model_ids is not None:
        return _network_sums_mixed(cfg, clock_ghz, workload.layers, model_ids)
    return _network_sums(cfg, clock_ghz, workload.layers)


def _finish(cost, clock_ghz, area_mm2, leak_mw) -> DseResult:
    """Network cost sums -> DSE metric columns, on HOST in float64."""
    f64 = lambda x: host(x).astype(np.float64)  # noqa: E731
    cycles, util, macs = f64(cost.cycles), f64(cost.utilization), f64(cost.macs)
    e_mac, e_mem = f64(cost.energy_mac_pj), f64(cost.energy_mem_pj)
    e_dram = f64(cost.energy_dram_pj)
    clock_ghz, area_mm2 = f64(clock_ghz), f64(area_mm2)
    latency_s = cycles / (clock_ghz * 1e9)
    # chip energy = dynamic access-count energy + leakage x runtime; DRAM
    # energy is invisible to a synthesis flow and reported separately
    e_chip = (e_mac + e_mem) * 1e-12 + f64(leak_mw) * 1e-3 * latency_s
    perf = 1.0 / np.maximum(latency_s, 1e-12)
    return DseResult(
        latency_s=latency_s, energy_j=e_chip,
        energy_total_j=e_chip + e_dram * 1e-12,
        area_mm2=area_mm2,
        power_mw=e_chip / np.maximum(latency_s, 1e-12) * 1e3,
        clock_ghz=clock_ghz, perf=perf,
        perf_per_area=perf / np.maximum(area_mm2, 1e-9),
        utilization=util, macs=macs)


class PendingChunk(NamedTuple):
    """A dispatched chunk: both stages and the copy of their sums to the
    host queued on the current stream.  ``finish_chunk`` waits for it."""
    cost: object                 # dataflow LayerCost sums (device tensors)
    clock: object
    area: object
    leak: object
    n: int                       # real (unpadded) lane count
    rows: object = None          # host (pinned on a card) copy of the sums
    done: object = None          # CUDA event after the copy (None: ready)
    staged: tuple = ()           # pinned upload buffers, alive until done


def _queue_transfer(cost, clock, area, leak, n: int,
                    staged: tuple = ()) -> PendingChunk:
    """Queue the copy of a chunk's sums to the host: on a card into a
    pinned buffer, on the current stream, with an event recorded after
    it; on the CPU the rows are already there."""
    rows = torch.stack([*cost, clock, area, leak])[:, :n]
    if rows.device.type != "cuda":
        return PendingChunk(cost, clock, area, leak, n, rows, None, staged)
    buf = torch.empty(rows.shape, dtype=rows.dtype, pin_memory=True)
    buf.copy_(rows, non_blocking=True)
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(rows.device))
    return PendingChunk(cost, clock, area, leak, n, buf, done, staged)


def _traced_dispatch(tr, cfg, workload, model, pad_to, model_ids=None,
                     track: str | None = None) -> PendingChunk:
    """``dispatch_chunk`` under a ``dispatch`` span."""
    if not tr.enabled:
        return dispatch_chunk(cfg, workload, model, pad_to=pad_to,
                              model_ids=model_ids)
    with tr.span("dispatch", track=track):
        return dispatch_chunk(cfg, workload, model, pad_to=pad_to,
                              model_ids=model_ids)


def _traced_finish(tr, pending: PendingChunk,
                   track: str | None = None) -> "DseResult":
    """``finish_chunk`` under a ``device_wait`` span: on a card the host
    blocked on the chunk's event (the device time the pipeline did not
    hide); on the CPU only the host copy, since dispatch did the work."""
    if not tr.enabled:
        return finish_chunk(pending)
    with tr.span("device_wait", track=track):
        return finish_chunk(pending)


def _pad_config(cfg: AcceleratorConfig, pad: int) -> AcceleratorConfig:
    """Repeat the last design point ``pad`` times (the fixed chunk shape);
    padded lanes are sliced off after evaluation."""
    return AcceleratorConfig(*[
        torch.cat([f, f[-1:].expand((pad,) + tuple(f.shape[1:]))])
        for f in cfg])


def _slice_config(cfg: AcceleratorConfig, lo: int, hi: int) -> AcceleratorConfig:
    return AcceleratorConfig(*[f[lo:hi] for f in cfg])


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def evaluate_chunk(cfg: AcceleratorConfig,
                   workload: Workload | StackedWorkload,
                   surrogate: PPAModels | CostModel | str | None = None,
                   pad_to: int | None = None,
                   model_ids=None) -> DseResult:
    """Evaluate one batch (padded up to ``pad_to`` lanes) and return the
    host result; ``surrogate`` selects the cost-model backend
    (``None`` = the synthesis oracle).

    A ``StackedWorkload`` with per-lane ``model_ids`` (positions into the
    stack) evaluates a MIXED-model chunk; each lane's result equals its
    evaluation under its own unpadded workload, bit for bit.
    """
    return finish_chunk(dispatch_chunk(cfg, workload, surrogate,
                                       pad_to=pad_to, model_ids=model_ids))


def _lane_ids(model_ids, n: int, n_models: int) -> np.ndarray:
    mids = np.asarray(model_ids, np.int64)
    if mids.shape != (n,):
        raise ValueError(f"model_ids shape {mids.shape} != ({n},)")
    if mids.size and (mids.min() < 0 or mids.max() >= n_models):
        raise ValueError(f"model_ids out of range for {n_models} "
                         f"stacked models")
    return mids


def _pad_ids(mids: np.ndarray, pad: int) -> np.ndarray:
    """Padded lanes repeat the last (model, config) lane."""
    return np.concatenate([mids, np.broadcast_to(mids[-1:], (pad,))])


def _host_config(cfg: AcceleratorConfig) -> AcceleratorConfig:
    """Every field a tensor on the config's own device (numpy: the CPU)."""
    src = torch.as_tensor(cfg.pe_rows).device
    return AcceleratorConfig(*[torch.as_tensor(f, device=src) for f in cfg])


def dispatch_chunk(cfg: AcceleratorConfig,
                   workload: Workload | StackedWorkload,
                   surrogate: PPAModels | CostModel | str | None = None,
                   pad_to: int | None = None,
                   model_ids=None) -> PendingChunk:
    """Validate, pad and queue one chunk on the workload's device and the
    current stream: the upload of its configs, both stages and the copy
    of the sums to the host.  Returns before the device has finished."""
    stacked = isinstance(workload, StackedWorkload)
    if stacked != (model_ids is not None):
        raise ValueError("model_ids must be given with a StackedWorkload "
                         "and only with one")
    model = as_cost_model(surrogate)
    model.validate(cfg)
    cfg = _host_config(cfg)
    if cfg.pe_rows.ndim == 0:  # single unbatched point: lift to (1,)
        cfg = AcceleratorConfig(*[f.reshape(1) for f in cfg])
    n = int(cfg.pe_rows.shape[0])
    mids = None
    if stacked:
        mids = _lane_ids(model_ids, n, int(workload.layers.H.shape[0]))
    if n == 0:
        return PendingChunk(None, None, None, None, 0)
    if pad_to is not None and n < pad_to:
        cfg = _pad_config(cfg, pad_to - n)
        if mids is not None:
            mids = _pad_ids(mids, pad_to - n)
    dev = _workload_device(workload)
    cfg, staged = config_to(cfg, dev)
    power, clock, area, leak = _ppa_stage(model.ppa_fn, model.ppa_params, cfg)
    del power  # nominal-activity power; the result's power column is
    #            derived from chip energy over runtime in _finish
    if mids is not None:
        mids, pinned = stage(mids, dev)
        staged += (pinned,)
    cost = _network_stage(cfg, clock, workload, mids)
    return _queue_transfer(cost, clock, area, leak, n, staged)


def finish_chunk(pending: PendingChunk) -> DseResult:
    """Wait for a dispatched chunk's copy to the host (its event, not the
    whole stream) and derive the float64 columns."""
    if pending.n == 0:
        return _empty_result()
    if pending.done is not None:
        pending.done.synchronize()
    rows = pending.rows.numpy()
    k = len(LayerCost._fields)
    res = _finish(LayerCost(*rows[:k]), *rows[k:])
    return DseResult(*[np.asarray(col, RESULT_DTYPES[f])
                       for f, col in zip(DseResult._fields, res)])


def _empty_result() -> DseResult:
    """Zero-point DseResult with the documented per-column host dtypes."""
    return DseResult(*[np.empty((0,), RESULT_DTYPES[f])
                       for f in DseResult._fields])


def evaluate_space(cfg: AcceleratorConfig, workload: Workload,
                   surrogate: PPAModels | CostModel | str | None = None,
                   chunk_size: int | None = None) -> DseResult:
    """Evaluate a batched design space on one workload.

    With ``chunk_size`` set, the batch runs in chunks of that many lanes
    and the host columns are concatenated, so device memory stays
    O(chunk_size).  A batch that fits one chunk is padded to the next
    power of two (capped at the chunk size), as in the reference.
    """
    n = int(np.shape(cfg.pe_rows)[0]) if np.ndim(cfg.pe_rows) else 1
    if n == 0:
        return _empty_result()
    if chunk_size is None or n <= chunk_size:
        pad = _next_pow2(n) if chunk_size is None \
            else min(chunk_size, _next_pow2(n))
        return evaluate_chunk(cfg, workload, surrogate, pad_to=pad)
    cols: list[list[np.ndarray]] = [[] for _ in DseResult._fields]
    for lo in range(0, n, chunk_size):
        res = evaluate_chunk(_slice_config(cfg, lo, min(lo + chunk_size, n)),
                             workload, surrogate, pad_to=chunk_size)
        for acc, col in zip(cols, res):
            acc.append(col)
    return DseResult(*[np.concatenate(c) for c in cols])


def chunk_dominators(obj: np.ndarray, block: int = 512):
    """``(front, dom)`` of one chunk's objective rows: ``front`` the rows
    of the chunk's own non-dominated front, ``dom[k, r]`` True when row
    ``front[k]`` strictly dominates row r (the archive's relation).

    Shared by every budget query reading the chunk: a query with
    feasibility mask ``m`` drops rows a FEASIBLE front row dominates
    (``dom[m[front]].any(0)``) before its archive fold, which is exact on
    both sides.  Blocked so the (block, N, D) temporary stays bounded.
    """
    obj = np.asarray(obj, np.float64)
    front = np.flatnonzero(ParetoArchive._chunk_front_mask(obj))
    f = obj[front]
    dom = np.empty((len(front), len(obj)), bool)
    for lo in range(0, len(front), block):
        blk = f[lo:lo + block, None, :]
        dom[lo:lo + block] = (np.all(blk >= obj[None, :, :], axis=-1)
                              & np.any(blk > obj[None, :, :], axis=-1))
    return front, dom


def fold_budget_chunk(archive, obj, idx, result=None, budget=None,
                      accuracy=None, stats=None, aux=(), dom=None,
                      telemetry=None, track=None):
    """Mask one evaluated chunk by ``budget`` and fold the survivors into
    ``archive``: the fold every budget-aware walk shares.

    ``result`` is anything ``Budget.feasibility`` reads (a ``DseResult``
    or a ``constraints.BudgetColumns`` view), ``accuracy`` a joint walk's
    per-lane accuracy, ``aux`` extra per-lane arrays masked in lockstep;
    ``dom`` (a ``chunk_dominators`` result) drops rows a feasible front
    row of the same chunk dominates first.  A ``None`` budget folds the
    chunk unmasked.  Returns the ``(obj, idx, aux)`` that reached the
    archive.  ``telemetry`` counts the kills and times the ``archive``
    span.
    """
    tr = as_tracer(telemetry)
    mask = None
    if budget is not None:
        mask, kills = budget.feasibility(result, accuracy=accuracy)
        if stats is not None:
            stats.record(mask, kills)
        if tr.enabled:
            _count_kills(tr, len(mask) - int(np.count_nonzero(mask)), kills)
        if mask.all():
            mask = None
    if dom is not None:
        front, adj = dom
        keep = ~adj.any(axis=0) if mask is None \
            else mask & ~adj[mask[front]].any(axis=0)
        if not keep.all():
            mask, (obj, idx) = None, (obj[keep], idx[keep])
            aux = tuple(a[keep] for a in aux)
    if mask is not None:
        obj, idx = obj[mask], idx[mask]
        aux = tuple(a[mask] for a in aux)
    with tr.span("archive", track=track):
        archive.update(obj, idx)
    return obj, idx, aux


def _count_kills(tr, killed: int, kills: dict) -> None:
    """The ``budget.killed`` / ``budget.kill.<constraint>`` counters."""
    if killed:
        tr.counter("budget.killed", killed)
    for cname, k in kills.items():
        if k:
            tr.counter(f"budget.kill.{cname}", k)


class _PPAView(NamedTuple):
    """The stage-1 columns a config-stage constraint can read (duck-typed
    into ``Budget.feasibility``; accuracy is passed separately)."""
    area_mm2: np.ndarray


class TwoStagePruner:
    """Config-only constraint pre-pruning for the streaming walks.

    Stage 1 runs the PPA stage on every raw chunk (padded to the fixed
    chunk shape), applies the budget's CONFIG-stage bounds (chip area;
    per-lane accuracy on joint walks) to the host float32 PPA columns,
    and buffers the survivors on the host: config rows, clock / area /
    leakage (float32), global indices, stacked-model ids and any ``aux``
    arrays.  Whenever a full chunk of survivors is buffered, stage 2
    folds the dataflow over exactly those lanes at the same chunk shape
    (a trailing partial flush repeats its last lane), with stage 1's
    clock / area / leakage passed through, not recomputed.
    Workload-stage bounds then mask each flush, so yielded chunks hold
    fully feasible lanes only.  Both stages run on the workload's device
    and the current stream; stage 1 waits for its PPA columns.

    Every lane's columns equal its single-stage values bit for bit:
    pruning only removes rows.  Accounting (``BudgetStats``): every raw
    lane counts as evaluated, config-stage kills are counted over all of
    them, stage-1 casualties land in ``pruned``, and workload-stage kills
    are counted over the survivors only.  ``state_dict`` /
    ``restore_state`` round-trip the survivor buffer for checkpoints.
    """

    def __init__(self, budget: Budget, chunk_size: int,
                 model: CostModel | PPAModels | str | None = None,
                 stats: BudgetStats | None = None,
                 telemetry=None, track: str | None = None):
        config_cons = budget.config_constraints()
        if not config_cons:
            raise ValueError("TwoStagePruner needs a budget with at least "
                             "one config-stage bound (area_mm2 / "
                             "min_accuracy): a purely workload-bounded "
                             "walk has nothing to prune early")
        self.budget = budget
        self.chunk_size = int(chunk_size)
        self.model = as_cost_model(model)
        self.stats = stats
        self._tr = as_tracer(telemetry)
        self._track = track
        self._config_cons = config_cons
        self._workload_cons = budget.workload_constraints()
        if stats is not None:
            # stable kill keys even for a stage that never rejects a lane
            stats.merge_kills({c.name: 0 for c in budget.constraints()})
        self._workload = None           # current stage-2 fold target
        self._mixed = None              # mixed vs plain, pinned per buffer
        self._frags: list[dict] = []    # buffered survivor fragments
        self._n = 0                     # buffered survivor count

    def __len__(self) -> int:
        """Currently buffered (config-feasible, not yet folded) lanes."""
        return self._n

    def feed(self, cfg: AcceleratorConfig, indices, workload,
             model_ids=None, aux: dict | None = None):
        """Stage-1 one raw chunk; yield any completed stage-2 flushes as
        ``(result, indices, aux)``.

        Feeding a different ``workload`` object first drains the buffer
        (survivors of different folds cannot share a flush).
        ``aux["accuracy"]`` also binds a ``min_accuracy`` bound.
        """
        if isinstance(workload, StackedWorkload) != (model_ids is not None):
            raise ValueError("model_ids must be given with a StackedWorkload "
                             "and only with one")
        if self._n and workload is not self._workload:
            yield from self._drain()
        self._workload = workload
        self._mixed = model_ids is not None
        idx = np.asarray(indices, np.int64)
        n = len(idx)
        if n == 0:
            return
        if n > self.chunk_size:
            raise ValueError(f"chunk of {n} lanes exceeds the pruner's "
                             f"chunk shape ({self.chunk_size}): feed chunks "
                             f"at most chunk_size long")
        with self._tr.span("prune_stage1", track=self._track):
            self.model.validate(cfg)
            cfg = _host_config(cfg)
            cfg_p = _pad_config(cfg, self.chunk_size - n) \
                if n < self.chunk_size else cfg
            cfg_p, _staged = config_to(cfg_p, _workload_device(workload))
            _, clock, area, leak = _ppa_stage(self.model.ppa_fn,
                                              self.model.ppa_params, cfg_p)
            clock, area, leak = host(torch.stack([clock, area, leak])[:, :n])
            accuracy = None if aux is None else aux.get("accuracy")
            mask, kills = self.budget.feasibility(
                _PPAView(area_mm2=area), accuracy=accuracy,
                constraints=self._config_cons)
        kept = int(np.count_nonzero(mask))
        if self._tr.enabled:
            _count_kills(self._tr, n - kept, kills)
        if self.stats is not None:
            self.stats.record_evaluated(n, kills)
            self.stats.record_pruned(n - kept)
            if not self._workload_cons:
                self.stats.record_feasible(kept)
        if kept == 0:
            return
        rows = slice(None) if kept == n else np.flatnonzero(mask)
        frag = dict(cfg=take_config(cfg, rows), clock=clock[rows],
                    area=area[rows], leak=leak[rows], idx=idx[rows])
        if model_ids is not None:
            frag["model_ids"] = np.asarray(model_ids, np.int64)[rows]
        frag["aux"] = {} if aux is None else \
            {k: np.asarray(v)[rows] for k, v in aux.items()}
        self._frags.append(frag)
        self._n += kept
        if self._tr.enabled:
            self._tr.gauge("prune.buffered", self._n, track=self._track)
        while self._n >= self.chunk_size:
            out = self._flush(self.chunk_size)
            if out is not None:
                yield out

    def finish(self):
        """Drain the final partial buffer (padded to the chunk shape)."""
        yield from self._drain()

    def state_dict(self) -> dict:
        """The buffered survivors as checkpointable plain data (host
        arrays).  The stage-2 fold target (``workload``) is not
        serialized: the caller re-binds it on restore."""
        state = dict(n=int(self._n), mixed=self._mixed)
        if self._n:
            m = self._merged()
            frag = dict(cfg={f: host(getattr(m["cfg"], f))
                             for f in AcceleratorConfig._fields},
                        clock=m["clock"], area=m["area"], leak=m["leak"],
                        idx=m["idx"],
                        aux={k: np.asarray(v) for k, v in m["aux"].items()})
            if self._mixed:
                frag["model_ids"] = m["model_ids"]
            state["frag"] = frag
        return state

    def restore_state(self, state: dict, workload) -> None:
        """Rebuild the survivor buffer from ``state_dict()`` and re-bind
        the stage-2 fold target: ``workload`` must be the one the walk
        was feeding when it saved."""
        self._n = int(state["n"])
        self._mixed = state["mixed"]
        self._workload = workload if self._n else None
        self._frags = []
        if self._n:
            f = state["frag"]
            cfg = AcceleratorConfig(**{
                k: torch.as_tensor(np.asarray(v), dtype=torch.int32
                                   if k == "pe_type" else torch.float32)
                for k, v in f["cfg"].items()})
            frag = dict(cfg=cfg,
                        clock=np.asarray(f["clock"]),
                        area=np.asarray(f["area"]),
                        leak=np.asarray(f["leak"]),
                        idx=np.asarray(f["idx"], np.int64),
                        aux={k: np.asarray(v) for k, v in f["aux"].items()})
            if self._mixed:
                frag["model_ids"] = np.asarray(f["model_ids"], np.int64)
            self._frags = [frag]

    def _drain(self):
        while self._n:
            out = self._flush(min(self._n, self.chunk_size))
            if out is not None:
                yield out

    def _merged(self) -> dict:
        if len(self._frags) > 1:
            cat = lambda key: np.concatenate(  # noqa: E731
                [f[key] for f in self._frags])
            merged = dict(cfg=concat_configs([f["cfg"] for f in self._frags]),
                          clock=cat("clock"), area=cat("area"),
                          leak=cat("leak"), idx=cat("idx"))
            if self._mixed:
                merged["model_ids"] = cat("model_ids")
            merged["aux"] = {k: np.concatenate([f["aux"][k]
                                                for f in self._frags])
                             for k in self._frags[0]["aux"]}
            self._frags = [merged]
        return self._frags[0]

    def _flush(self, count: int):
        """Fold ``count`` buffered survivors through stage 2; returns the
        feasible ``(result, indices, aux)`` or None if the workload-stage
        bounds killed the whole flush."""
        merged = self._merged()
        head, tail = {}, {}
        for k, v in merged.items():
            if k == "cfg":
                head[k] = take_config(v, slice(0, count))
                tail[k] = take_config(v, slice(count, None))
            elif k == "aux":
                head[k] = {a: w[:count] for a, w in v.items()}
                tail[k] = {a: w[count:] for a, w in v.items()}
            else:
                head[k], tail[k] = v[:count], v[count:]
        self._frags = [tail] if self._n > count else []
        self._n -= count
        if self._tr.enabled:
            self._tr.counter("prune.flushes")
        return self._stage2(head, count)

    def _stage2(self, lanes: dict, n: int):
        pad = self.chunk_size - n
        cfg = lanes["cfg"]
        dev = _workload_device(self._workload)
        ppa = np.stack([lanes["clock"], lanes["area"], lanes["leak"]])
        mids = lanes.get("model_ids")
        if pad:
            cfg = _pad_config(cfg, pad)
            ppa = np.concatenate([ppa, np.repeat(ppa[:, -1:], pad, 1)], 1)
            mids = None if mids is None else _pad_ids(mids, pad)
        with self._tr.span("prune_stage2", track=self._track):
            cfg, staged = config_to(cfg, dev)
            ppa, pinned = stage(ppa, dev)
            staged += (pinned,)
            if mids is not None:
                mids, pinned = stage(mids, dev)
                staged += (pinned,)
            clock, area, leak = ppa
            cost = _network_stage(cfg, clock, self._workload, mids)
            res = finish_chunk(_queue_transfer(cost, clock, area, leak, n,
                                               staged))
        idx, aux = lanes["idx"], lanes["aux"]
        if self._workload_cons:
            # workload-stage bounds never read "accuracy" (config-stage)
            mask, kills = self.budget.feasibility(
                res, constraints=self._workload_cons)
            kept = int(np.count_nonzero(mask))
            if self._tr.enabled:
                _count_kills(self._tr, n - kept, kills)
            if self.stats is not None:
                self.stats.merge_kills(kills)
                self.stats.record_feasible(kept)
            if kept == 0:
                return None
            if kept < n:
                res = mask_result(res, mask)
                idx = idx[mask]
                aux = {k: v[mask] for k, v in aux.items()}
        return res, idx, aux


def _workload_device(workload: Workload | StackedWorkload) -> torch.device:
    return workload.layers.H.device


def evaluate_space_streaming(
        workload: Workload,
        space: dict | None = None,
        surrogate: PPAModels | CostModel | str | None = None,
        chunk_size: int = DEFAULT_CHUNK_SIZE,
        max_points: int | None = None,
        seed: int = 0,
        budget: Budget | None = None,
        budget_stats: BudgetStats | None = None,
        prune: bool = True,
        shards: int | None = None,
        devices=None,
        pipeline_depth: int | None = None,
        telemetry=None,
) -> Iterator[tuple[DseResult, np.ndarray]]:
    """Lazily evaluate the cartesian design space chunk by chunk, on the
    device of ``workload``.

    Yields ``(chunk_result, flat_indices)``, every chunk evaluated at the
    fixed ``chunk_size`` shape with the padded tail trimmed.  With a
    ``budget`` the infeasible lanes are dropped on the host before a
    chunk is yielded (bit-identical to filtering the unconstrained walk
    post hoc), fully infeasible chunks are skipped, and ``budget_stats``
    collects the counts.  A budget with config-stage bounds runs
    two-stage (``TwoStagePruner``) unless ``prune=False``: same feasible
    lanes, same columns, different chunk boundaries.

    ``shards=`` / ``devices=`` / ``pipeline_depth=`` route the walk
    through the pipelined multi-stream walk of ``repro_torch.core.shard``
    (same point set, every lane bit-identical).  ``telemetry=`` times the
    decode / dispatch / device-wait / pruner phases and counts points
    and budget kills; yielded chunks are bit-identical with it on or off.
    """
    tr = as_tracer(telemetry)
    if shards is not None or devices is not None:
        from repro_torch.core import shard as _shard
        yield from _shard.sharded_space_stream(
            workload, space, surrogate, chunk_size=chunk_size,
            max_points=max_points, seed=seed, budget=budget,
            budget_stats=budget_stats, prune=prune, shards=shards,
            devices=devices,
            pipeline_depth=(_shard.DEFAULT_PIPELINE_DEPTH
                            if pipeline_depth is None else pipeline_depth),
            telemetry=telemetry)
        return
    model = as_cost_model(surrogate)
    chunks = timed_iter(iter_space_chunks(space, chunk_size=chunk_size,
                                          max_points=max_points, seed=seed,
                                          device="cpu"), tr)
    if budget is not None and prune and budget.config_constraints():
        pruner = TwoStagePruner(budget, chunk_size, model, budget_stats,
                                telemetry=telemetry)
        for cfg, idx in chunks:
            if tr.enabled:
                tr.counter("sweep.points", len(idx))
            for res, fidx, _aux in pruner.feed(cfg, idx, workload):
                yield res, fidx
        for res, fidx, _aux in pruner.finish():
            yield res, fidx
        return
    for cfg, idx in chunks:
        n_raw = len(idx)
        if tr.enabled:
            tr.counter("sweep.points", n_raw)
        res = _traced_finish(tr, _traced_dispatch(tr, cfg, workload, model,
                                                  chunk_size))
        if budget is not None:
            res, idx = apply_budget(res, idx, budget, stats=budget_stats)
            if tr.enabled and len(idx) < n_raw:
                tr.counter("budget.killed", n_raw - len(idx))
            if len(idx) == 0:
                continue
        yield res, idx


# ---------------------------------------------------------------------------
# Pareto analysis
# ---------------------------------------------------------------------------

def pareto_mask_dense(objectives: torch.Tensor) -> torch.Tensor:
    """Non-dominated mask, O(N^2) broadcast: the reference oracle.

    objectives: (N, D), all HIGHER-IS-BETTER.  Point i is dominated iff
    some j is >= on every objective and > on at least one.
    """
    a = objectives[:, None, :]   # i
    b = objectives[None, :, :]   # j
    ge = torch.all(b >= a, dim=-1)
    gt = torch.any(b > a, dim=-1)
    return ~torch.any(ge & gt, dim=1)


def pareto_mask_tiled(objectives: torch.Tensor,
                      block_size: int = 1024) -> torch.Tensor:
    """Non-dominated mask with O(N * block_size) memory, any D: all N
    points against one block of candidate dominators at a time, OR-ed
    into the dominated accumulator.  Equal to ``pareto_mask_dense``."""
    obj = torch.as_tensor(objectives)
    n = obj.shape[0]
    dominated = torch.zeros(n, dtype=torch.bool, device=obj.device)
    for lo in range(0, n, block_size):
        blk = obj[lo:lo + block_size]
        ge = torch.all(blk[None, :, :] >= obj[:, None, :], dim=-1)
        gt = torch.any(blk[None, :, :] > obj[:, None, :], dim=-1)
        dominated |= torch.any(ge & gt, dim=1)
    return ~dominated


def pareto_mask_2d(objectives: np.ndarray) -> np.ndarray:
    """Sort-based O(N log N) non-dominated mask for 2 objectives, on the
    host in float64; equal points never dominate each other."""
    obj = host(objectives).astype(np.float64)
    n, d = obj.shape
    if d != 2:
        raise ValueError(f"pareto_mask_2d needs 2 objectives, got {d}")
    if n == 0:
        return np.zeros((0,), bool)
    x, y = obj[:, 0], obj[:, 1]
    order = np.lexsort((-y, -x))          # x desc, ties broken y desc
    xs, ys = x[order], y[order]
    new_group = np.r_[True, xs[1:] != xs[:-1]]
    group_id = np.cumsum(new_group) - 1
    group_max = np.maximum.reduceat(ys, np.flatnonzero(new_group))
    prev_max = np.r_[-np.inf, np.maximum.accumulate(group_max)[:-1]]
    dominated = (prev_max[group_id] >= ys) | (group_max[group_id] > ys)
    mask = np.empty(n, bool)
    mask[order] = ~dominated
    return mask


# N above which the dispatcher refuses the O(N^2) dense path.
_DENSE_LIMIT = 4096


def pareto_mask(objectives, method: str = "auto",
                block_size: int = 1024) -> torch.Tensor:
    """Non-dominated mask of (N, D) HIGHER-IS-BETTER objectives, on the
    device of ``objectives`` (the CPU for a numpy array).

    method: "auto" (sorted when D == 2, dense for small N, else tiled),
    "dense", "tiled" or "sorted" (2 objectives, host).  All agree exactly.
    """
    obj = torch.as_tensor(objectives)
    n, d = obj.shape
    if method == "auto":
        if d == 2:
            method = "sorted"
        elif n <= _DENSE_LIMIT:
            method = "dense"
        else:
            method = "tiled"
    if method == "dense":
        return pareto_mask_dense(obj)
    if method == "tiled":
        return pareto_mask_tiled(obj, block_size=block_size)
    if method == "sorted":
        return torch.as_tensor(pareto_mask_2d(obj), device=obj.device)
    raise ValueError(f"unknown pareto_mask method {method!r}")


def _objective_columns(result: DseResult, metrics: Sequence[str]) -> np.ndarray:
    """(N, D) higher-is-better objective matrix from DseResult fields;
    a ``neg_`` prefix flips a lower-is-better metric."""
    cols = []
    for m in metrics:
        if m.startswith("neg_"):
            cols.append(-np.asarray(getattr(result, m[4:]), np.float64))
        else:
            cols.append(np.asarray(getattr(result, m), np.float64))
    return np.stack(cols, axis=-1)


def pareto_front(result: DseResult,
                 metrics: tuple = ("perf_per_area", "neg_energy_j"),
                 method: str = "auto") -> torch.Tensor:
    return pareto_mask(_objective_columns(result, metrics), method=method)


def _dominated_by(points: np.ndarray, front: np.ndarray) -> np.ndarray:
    """Is ``points[i]`` dominated by some row of ``front``?
    O(len(points) * len(front) * D): cheap while ``front`` is small."""
    if len(front) == 0 or len(points) == 0:
        return np.zeros(len(points), bool)
    ge = np.all(front[None, :, :] >= points[:, None, :], axis=-1)
    gt = np.any(front[None, :, :] > points[:, None, :], axis=-1)
    return np.any(ge & gt, axis=1)


def _self_nondominated(pts: np.ndarray) -> np.ndarray:
    """Dense pairwise non-dominated mask of ``pts`` against itself,
    O(N^2 * D): for small N (a block of a chunk)."""
    ge = np.all(pts[None, :, :] >= pts[:, None, :], axis=-1)
    gt = np.any(pts[None, :, :] > pts[:, None, :], axis=-1)
    return ~np.any(ge & gt, axis=1)


class ParetoArchive:
    """Streaming non-dominated archive, on the host in float64.

    ``update(objectives, indices)`` chunk by chunk keeps exactly the
    points that are non-dominated in the concatenation of everything seen
    so far (duplicates of a non-dominated point all stay).  State is
    O(front size).
    """

    def __init__(self, num_objectives: int):
        self._obj = np.empty((0, num_objectives), np.float64)
        self._idx = np.empty((0,), np.int64)
        self._seen = 0  # total points fed (default index stream)

    def __len__(self) -> int:
        return len(self._idx)

    @property
    def objectives(self) -> np.ndarray:
        """(A, D) objectives of the current front."""
        return self._obj

    @property
    def indices(self) -> np.ndarray:
        """Global flat indices of the current front's design points."""
        return self._idx

    def state_dict(self) -> dict:
        """The archive's complete state as plain data."""
        return dict(objectives=self._obj.copy(), indices=self._idx.copy(),
                    seen=int(self._seen))

    @classmethod
    def from_state(cls, state: dict) -> "ParetoArchive":
        """Rebuild an archive from ``state_dict()``; it continues bit for
        bit (front row order is part of the state)."""
        obj = np.asarray(state["objectives"], np.float64)
        archive = cls(obj.shape[1])
        archive._obj = obj
        archive._idx = np.asarray(state["indices"], np.int64)
        archive._seen = int(state["seen"])
        return archive

    @staticmethod
    def _chunk_front_mask(obj: np.ndarray, block: int = 512) -> np.ndarray:
        """Exact non-dominated mask of one chunk, bounded memory.

        D == 2 uses the sort-based mask.  For D >= 3 the rows are scanned
        in lexicographic-descending order in blocks: a dominator is
        lex-greater, so it lies in an earlier block (checked against the
        running front) or in the same block (a dense pass).
        """
        n, d = obj.shape
        if d == 2:
            return pareto_mask_2d(obj)
        if n <= block:
            return _self_nondominated(obj)
        order = np.lexsort(tuple(-obj[:, k] for k in range(d - 1, -1, -1)))
        s = obj[order]
        keep = np.zeros(n, bool)
        front = np.empty((0, d), np.float64)
        for lo in range(0, n, block):
            blk = s[lo:lo + block]
            alive = np.flatnonzero(~_dominated_by(blk, front))
            alive = alive[_self_nondominated(blk[alive])]
            keep[lo + alive] = True
            front = np.concatenate([front, blk[alive]])
        mask = np.zeros(n, bool)
        mask[order] = keep
        return mask

    def update(self, objectives: np.ndarray,
               indices: np.ndarray | None = None) -> None:
        obj = np.asarray(objectives, np.float64)
        if obj.ndim != 2 or obj.shape[1] != self._obj.shape[1]:
            raise ValueError(f"expected (N, {self._obj.shape[1]}) objectives, "
                             f"got {obj.shape}")
        if not np.isfinite(obj).all():
            # a NaN row can never be dominated and a +inf row dominates
            # everything: either corrupts the front, so refuse loudly
            bad = np.flatnonzero(~np.isfinite(obj).all(axis=1))
            raise ValueError(
                f"objectives contain non-finite values (NaN/inf) in "
                f"{len(bad)} row(s) (first: {bad[:5].tolist()}): a NaN row "
                f"can never be dominated and a +inf row dominates "
                f"everything; either corrupts the archive front")
        idx = (np.arange(self._seen, self._seen + len(obj))
               if indices is None else np.asarray(indices, np.int64))
        self._seen += len(obj)
        # drop candidates the front already dominates, then reduce the
        # survivors to their own front (host float64 throughout)
        if len(self._obj) and len(obj):
            keep = ~_dominated_by(obj, self._obj)
            obj, idx = obj[keep], idx[keep]
        if len(obj) > 1:
            m = self._chunk_front_mask(obj)
            obj, idx = obj[m], idx[m]
        if len(obj) == 0:
            return
        if len(self._obj):
            keep_old = ~_dominated_by(self._obj, obj)
            self._obj = np.concatenate([self._obj[keep_old], obj])
            self._idx = np.concatenate([self._idx[keep_old], idx])
        else:
            self._obj, self._idx = obj, idx


def pareto_front_streaming(
        workload: Workload,
        space: dict | None = None,
        metrics: tuple = ("perf_per_area", "neg_energy_j"),
        surrogate: PPAModels | CostModel | str | None = None,
        chunk_size: int = DEFAULT_CHUNK_SIZE,
        max_points: int | None = None,
        seed: int = 0,
        budget: Budget | None = None,
        budget_stats: BudgetStats | None = None,
        prune: bool = True,
        shards: int | None = None,
        devices=None,
        pipeline_depth: int | None = None,
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 64,
        csv_path: str | None = None,
        max_chunks: int | None = None,
        telemetry=None,
) -> tuple[ParetoArchive, AcceleratorConfig]:
    """Pareto front of an arbitrarily large design space in O(chunk)
    memory: ``evaluate_space_streaming`` folded into a ``ParetoArchive``.

    Returns the archive (objectives + global flat indices) and the decoded
    front configs (on the workload's device).  With ``budget`` set it is
    the front of the FEASIBLE subset, bit-identical to filtering an
    unconstrained walk post hoc.

    Any of ``shards`` / ``devices`` / ``pipeline_depth`` (round-robin
    shards with their own archives and streams, chunks in flight),
    ``checkpoint_dir`` / ``checkpoint_every`` (atomic snapshots; an
    existing checkpoint resumes the walk), ``csv_path`` (the decoded
    front streamed to CSV) or ``max_chunks`` (stop after that many
    chunks, a preemption) routes the walk through
    ``repro_torch.core.shard.sharded_pareto_front``, whose front is
    bit-identical (indices and objectives) to this fold.  ``telemetry=``
    instruments the walk without touching a value.
    """
    if (shards is not None or devices is not None
            or checkpoint_dir is not None or csv_path is not None
            or max_chunks is not None):
        from repro_torch.core import shard as _shard
        return _shard.sharded_pareto_front(
            workload, space, metrics=metrics, surrogate=surrogate,
            chunk_size=chunk_size, max_points=max_points, seed=seed,
            budget=budget, budget_stats=budget_stats, prune=prune,
            shards=shards, devices=devices,
            pipeline_depth=(_shard.DEFAULT_PIPELINE_DEPTH
                            if pipeline_depth is None else pipeline_depth),
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, csv_path=csv_path,
            max_chunks=max_chunks, telemetry=telemetry)
    tr = as_tracer(telemetry)
    archive = ParetoArchive(len(metrics))
    for res, idx in evaluate_space_streaming(
            workload, space, surrogate=surrogate, chunk_size=chunk_size,
            max_points=max_points, seed=seed, budget=budget,
            budget_stats=budget_stats, prune=prune, telemetry=telemetry):
        with tr.span("archive"):
            archive.update(_objective_columns(res, metrics), idx)
    return archive, space_points(archive.indices, space,
                                 _workload_device(workload))


# ---------------------------------------------------------------------------
# The paper's normalized reporting (Figs. 4-6)
# ---------------------------------------------------------------------------

def best_index(result: DseResult, pe_type, code: int | None,
               metric: str = "perf_per_area", mode: str = "max") -> int:
    """Index of the best design of a given PE type under a metric
    (``code=None`` ranks the whole space; a type absent from the space
    falls back to the global best)."""
    vals = np.asarray(getattr(result, metric), np.float64)
    if code is not None:
        sel = np.atleast_1d(host(pe_type)) == code
        if sel.any():
            vals = np.where(sel, vals, -np.inf if mode == "max" else np.inf)
    return int(np.argmax(vals) if mode == "max" else np.argmin(vals))


def normalized_report(result: DseResult, cfg: AcceleratorConfig) -> dict:
    """Per-PE-type best configs, normalized to the best-perf/area INT16
    design: the normalization of the paper's Figs. 4-6.  Without an INT16
    design the global best becomes the reference, recorded under
    ``"_reference"``."""
    types = np.atleast_1d(host(cfg.pe_type))
    has_int16 = bool((types == PE_INT16).any())
    ref = best_index(result, types, PE_INT16 if has_int16 else None,
                     "perf_per_area")
    ref_ppa = float(result.perf_per_area[ref])
    ref_energy = float(result.energy_j[ref])
    report = {"_reference": dict(
        pe_type=PE_TYPE_NAMES[int(types[ref])], index=ref,
        fallback=not has_int16,
        note=None if has_int16 else
        "no INT16 design in space; normalized to global best perf/area")}
    for code, name in enumerate(PE_TYPE_NAMES):
        if not (types == code).any():
            continue
        i_ppa = best_index(result, types, code, "perf_per_area")
        i_en = best_index(result, types, code, "energy_j", "min")
        report[name] = dict(
            best_perf_per_area=float(result.perf_per_area[i_ppa]),
            norm_perf_per_area=float(result.perf_per_area[i_ppa]) / ref_ppa,
            best_energy_j=float(result.energy_j[i_en]),
            norm_energy=float(result.energy_j[i_en]) / ref_energy,
            energy_at_best_ppa=float(result.energy_j[i_ppa]) / ref_energy,
            index_best_ppa=i_ppa, index_best_energy=i_en,
        )
    return report


def report_pe_types(report: dict) -> dict:
    """The per-PE-type entries of a normalized report (metadata dropped)."""
    return {k: v for k, v in report.items() if not k.startswith("_")}


def spread(result: DseResult) -> dict:
    """Fig. 2: how much perf/area and energy vary across the space."""
    ppa = np.asarray(result.perf_per_area, np.float64)
    en = np.asarray(result.energy_j, np.float64)
    return dict(perf_per_area_spread=float(ppa.max() / max(ppa.min(), 1e-30)),
                energy_spread=float(en.max() / max(en.min(), 1e-30)))
