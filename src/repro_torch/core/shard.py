"""Sharded, pipelined, checkpointable streaming sweeps (port of
``repro.core.shard``).

The streaming walks of ``dse`` / ``coexplore`` are single-process folds:
one chunk dispatched, one finished, one archive.  This module runs the
SAME walk as a pipeline over shards without changing an evaluated bit:

* **Sharding.**  The chunk sequence of ``arch.iter_space_chunks`` /
  ``iter_joint_space_chunks`` is dealt round-robin across S shards
  (chunk c -> shard ``c % S``).  Shard s evaluates on
  ``devices[s % len(devices)]`` (default: every card, ``cuda:{s % n}``;
  a walk whose workload the caller put on the CPU stays there) and folds
  into its own ``ParetoArchive``.  Chunk boundaries, the subsample and
  every lane's columns are the single-process walk's, and the archive
  reduction is exact, so the pairwise-merged front (``merge_archives``)
  is bit-identical (indices and objectives) to the unsharded one.  More
  shards than devices is allowed: devices repeat round-robin.

* **Pipelining.**  On a card every shard has its own CUDA stream.  A
  chunk's whole work runs on its shard's stream: the upload of its
  configs from a pinned buffer, both evaluation stages, and the copy of
  its sums into a pinned host buffer, followed by an event
  (``dse.dispatch_chunk``).  The driver keeps up to ``shards *
  pipeline_depth`` chunks in flight and blocks only on the OLDEST one's
  event (``dse.finish_chunk``), so the host's archive fold of chunk k
  overlaps the device work of the chunks after it.  Chunks retire
  strictly in dispatch order, so resume cursors stay dense.  The
  two-stage pruned path stays synchronous per shard (stage 1 waits for
  its PPA columns), each shard with its own pruner.  On the CPU the
  dispatch does the work eagerly, so nothing overlaps.

* **Durability.**  ``SweepCheckpointer`` snapshots the complete walk
  state (per-shard archive fronts, budget stats, pruner survivor buffers
  and the retire cursor) through ``repro_torch.checkpoint.manager.
  save_state`` every N retired chunks; resume skips the first ``cursor``
  chunks by index arithmetic (``start_chunk``) and reproduces the
  uninterrupted front.  A signature (space / chunking / budget /
  backend fingerprint) is stored with every checkpoint and verified on
  resume.  ``export_front_csv`` streams the decoded front to disk
  (atomic replace) as it evolves.
"""

from __future__ import annotations

import contextlib
import csv
import hashlib
import os
from collections import deque
from typing import Iterator, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import manager as _ckpt
from repro_torch.core.arch import (AcceleratorConfig, _space_axes,
                                   config_rows, iter_space_chunks,
                                   joint_space_points, space_points)
from repro_torch.core.constraints import Budget, BudgetStats, apply_budget
from repro_torch.core.costmodel import CostModel, as_cost_model
from repro_torch.core.dse import (DEFAULT_CHUNK_SIZE, ParetoArchive,
                                  TwoStagePruner, _objective_columns,
                                  _traced_dispatch, _traced_finish,
                                  _workload_device, dispatch_chunk,
                                  finish_chunk)
from repro_torch.core.workloads import LayerSpec
from repro_torch.device import host, same_device
from repro_torch.obs import NULL_TRACER, as_tracer, timed_iter

# In-flight chunks per shard: 2 = classic double buffering (one chunk on
# the device while the previous one's host fold runs).
DEFAULT_PIPELINE_DEPTH = 2


def _card_devices() -> tuple:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available to shard over; pass devices= "
            "(e.g. ['cpu'] * k) to shard on the CPU")
    return tuple(torch.device(f"cuda:{i}")
                 for i in range(torch.cuda.device_count()))


def resolve_shards(shards: int | None = None,
                   devices: Sequence | None = None) -> tuple[int, tuple]:
    """Normalize the ``shards=`` / ``devices=`` pair of the sweep APIs.

    ``devices`` defaults to every card (``cuda:0`` .. ``cuda:{n-1}``;
    raises without one); ``shards`` defaults to ``len(devices)`` when
    devices are given explicitly and 1 otherwise.  More shards than
    devices round-robins shards onto devices.
    """
    devs = tuple(torch.device(d) for d in devices) if devices is not None \
        else _card_devices()
    if not devs:
        raise ValueError("no devices to shard over")
    n = int(shards) if shards is not None \
        else (len(devs) if devices is not None else 1)
    if n < 1:
        raise ValueError(f"shards must be >= 1, got {n}")
    return n, devs


def _resolve_for(shards, devices, home: torch.device) -> tuple[int, tuple]:
    """``resolve_shards`` for a walk whose workload lives on ``home``: a
    walk the caller put on the CPU defaults to the CPU, not the cards."""
    if devices is None and home.type == "cpu":
        return (1 if shards is None else int(shards)), (home,)
    return resolve_shards(shards, devices)


def shard_device(devices: Sequence, shard: int):
    """The device a shard dispatches on (round-robin past the end)."""
    return devices[shard % len(devices)]


def _to_device(obj, device: torch.device):
    """A copy of a NamedTuple / tuple / list / dict tree with every tensor
    on ``device`` (other leaves shared)."""
    if torch.is_tensor(obj):
        return obj.to(device)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*[_to_device(v, device) for v in obj])
    if isinstance(obj, (tuple, list)):
        return type(obj)(_to_device(v, device) for v in obj)
    if isinstance(obj, dict):
        return {k: _to_device(v, device) for k, v in obj.items()}
    return obj


class _PlacedCostModel(CostModel):
    """A cost model with its fitted parameters copied to another device."""

    def __init__(self, base: CostModel, device: torch.device):
        self.name = base.name
        self.ppa_fn = base.ppa_fn
        self._base = base
        self._params = _to_device(base.ppa_params, device)

    @property
    def ppa_params(self):
        return self._params

    def validate(self, cfg: AcceleratorConfig) -> None:
        self._base.validate(cfg)


class _Shard:
    """One shard's device, its CUDA stream (cards only) and its copies of
    the walk's tensors (workloads, cost-model parameters) when its device
    is not the one they live on."""

    def __init__(self, device: torch.device, home: torch.device):
        self.device = device
        self.local = same_device(device, home)
        self.stream = None
        if device.type == "cuda":
            self.stream = torch.cuda.Stream(device=device)
            # tensors made before the walk (workloads, fitted params) on
            # the default stream are ready before the shard reads them
            self.stream.wait_stream(torch.cuda.current_stream(device))
        self._copies: dict[int, object] = {}

    def placed(self, obj):
        """``obj`` (a workload or a ``CostModel``) on this shard's device."""
        if self.local:
            return obj
        key = id(obj)
        if key not in self._copies:
            # copied on the shard's stream, so its chunks see the copy
            with self.active():
                self._copies[key] = (obj, _PlacedCostModel(obj, self.device)
                                     if isinstance(obj, CostModel)
                                     else _to_device(obj, self.device))
        return self._copies[key][1]

    def active(self):
        """Context under which a chunk's work runs: the shard's stream."""
        if self.stream is None:
            return contextlib.nullcontext()
        return _on_stream(self.device, self.stream)


@contextlib.contextmanager
def _on_stream(device, stream):
    with torch.cuda.device(device), torch.cuda.stream(stream):
        yield


def _make_shards(n_shards: int, devs: tuple,
                 home: torch.device) -> list[_Shard]:
    return [_Shard(shard_device(devs, s), home) for s in range(n_shards)]


def merge_archives(archives: Sequence[ParetoArchive],
                   num_objectives: int) -> ParetoArchive:
    """Reduce per-shard fronts pairwise into one exact global front.

    Pure (inputs untouched).  A point is on the merged front iff it is
    non-dominated in the union of everything any shard saw, so the
    merged (index, objective) row set is bit-identical to the
    single-archive walk's.  Pairwise tree reduction keeps every merge
    input front-sized.
    """
    level = [a for a in archives]
    if not level:
        return ParetoArchive(num_objectives)
    while len(level) > 1:
        nxt = []
        for i in range(0, len(level) - 1, 2):
            m = ParetoArchive(num_objectives)
            m.update(level[i].objectives, level[i].indices)
            m.update(level[i + 1].objectives, level[i + 1].indices)
            nxt.append(m)
        if len(level) % 2:
            nxt.append(level[-1])
        level = nxt
    if level[0] in archives:      # single shard: still return a copy
        m = ParetoArchive(num_objectives)
        m.update(level[0].objectives, level[0].indices)
        return m
    return level[0]


def merge_budget_stats(stats: Sequence[BudgetStats]) -> BudgetStats:
    """Sum per-shard feasibility telemetry (all fields are additive)."""
    out = BudgetStats()
    for s in stats:
        out.merge(s)
    return out


# ---------------------------------------------------------------------------
# Durability
# ---------------------------------------------------------------------------

class SweepCheckpointer:
    """Atomic every-N-chunks checkpointing of a sharded walk's state.

    A policy layer over ``checkpoint.manager.save_state`` /
    ``load_state``: the walk owns WHAT the state is (archives, stats,
    pruner buffers, cursor); this class owns WHEN it is written (every
    ``every`` retired chunks and once at the end), the keep-k GC, and the
    resume-safety signature check.
    """

    def __init__(self, ckpt_dir: str, every: int = 64, keep: int = 3,
                 signature: dict | None = None):
        self.dir = ckpt_dir
        self.every = max(1, int(every))
        self.keep = keep
        self.signature = signature or {}

    def load(self, step: int | None = None, telemetry=None) -> dict | None:
        """Latest (or given-step) state, or None for a fresh directory.
        Raises on a signature mismatch: resuming a walk with different
        chunking / space / budget arguments would corrupt the front."""
        step, state = _ckpt.load_state(self.dir, step, telemetry=telemetry)
        if state is None:
            return None
        if state.get("signature") != self.signature:
            raise ValueError(
                f"checkpoint at {self.dir!r} was written by a different "
                f"sweep: signature {state.get('signature')!r} != expected "
                f"{self.signature!r}; point checkpoint_dir at a fresh "
                f"directory or rerun with the original arguments")
        return state

    def due(self, cursor: int) -> bool:
        return cursor % self.every == 0

    def save(self, cursor: int, state: dict, telemetry=None) -> str:
        return _ckpt.save_state(self.dir, cursor,
                                dict(state, signature=self.signature),
                                keep=self.keep, telemetry=telemetry)


def space_signature(space: dict | None) -> dict:
    """JSON-stable fingerprint of an accelerator space (axis values in
    field order): part of the checkpoint signature."""
    return {f: [float(v) for v in axis]
            for f, axis in zip(AcceleratorConfig._fields,
                               _space_axes(space))}


def workloads_signature(models: Sequence) -> str:
    """Content digest of a model axis: every ``LayerSpec`` field of every
    workload (the phase-aware IR fields included) plus the per-model
    normalizers and accuracy class mix, as float64 bytes (the
    reference's digest for equal values).  Two axes with the same names
    but different layer IR hash differently."""
    h = hashlib.sha256()
    for m in models:
        h.update(m.name.encode())
        h.update(np.float64(m.macs).tobytes())
        h.update(np.float64(m.base_acc).tobytes())
        mix = getattr(m, "acc_mix", None)
        h.update(b"-" if mix is None
                 else np.asarray(mix, np.float64).tobytes())
        for f in LayerSpec._fields:
            h.update(host(getattr(m.workload.layers, f))
                     .astype(np.float64).tobytes())
    return h.hexdigest()[:16]


def _decode_front(archive: ParetoArchive, space, models):
    """Host decode of a front: (model ids or None, config)."""
    idx = archive.indices
    if models is not None:
        return joint_space_points(idx, space, num_models=len(models),
                                  device="cpu")
    return None, space_points(idx, space, "cpu")


def export_front_csv(path: str, archive: ParetoArchive,
                     metrics: Sequence[str], space: dict | None = None,
                     models: Sequence | None = None) -> str:
    """Write the decoded front to CSV atomically (tmp + ``os.replace``).

    Plain-space fronts get ``index`` + objective columns + the decoded
    config fields; joint fronts (``models`` given, a sequence of
    ``coexplore.ModelEntry``) also decode the model name per row.
    """
    idx = archive.indices
    obj = archive.objectives
    mids, cfgs = _decode_front(archive, space, models)
    tmp = f"{path}.tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "w", newline="") as f:
        w = csv.writer(f)
        head = ["index"]
        if models is not None:
            head += ["model"]
        head += list(metrics) + ["pe_type_name"] \
            + list(AcceleratorConfig._fields)
        w.writerow(head)
        for i, row in enumerate(config_rows(cfgs)):
            out = [int(idx[i])]
            if models is not None:
                out.append(models[int(mids[i])].name)
            out += [repr(float(v)) for v in obj[i]]
            out.append(row["pe_type_name"])
            out += [row[k] for k in AcceleratorConfig._fields]
            w.writerow(out)
    os.replace(tmp, path)
    return path


def _front_columns(archive: ParetoArchive, metrics: Sequence[str],
                   space: dict | None, models: Sequence | None) -> dict:
    """The decoded front as name -> column list."""
    idx = archive.indices
    obj = archive.objectives
    mids, cfgs = _decode_front(archive, space, models)
    cols: dict[str, list] = {"index": [int(i) for i in idx]}
    if models is not None:
        cols["model"] = [models[int(m)].name for m in mids]
    for j, m in enumerate(metrics):
        cols[m] = [float(v) for v in obj[:, j]]
    rows = list(config_rows(cfgs))
    cols["pe_type_name"] = [r["pe_type_name"] for r in rows]
    for k in AcceleratorConfig._fields:
        cols[k] = [r[k] for r in rows]
    return cols


def export_front_parquet(path: str, archive: ParetoArchive,
                         metrics: Sequence[str], space: dict | None = None,
                         models: Sequence | None = None) -> str:
    """Write the decoded front to Parquet atomically: the columnar twin
    of ``export_front_csv`` (same columns, same row order).  Needs
    ``pyarrow``; raises a clear ``RuntimeError`` without it."""
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except ImportError as e:  # pragma: no cover - env-dependent
        raise RuntimeError(
            "export_front_parquet requires pyarrow (not installed); "
            "use export_front_csv instead") from e
    cols = _front_columns(archive, metrics, space, models)
    table = pa.table({k: pa.array(v) for k, v in cols.items()})
    tmp = f"{path}.tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    pq.write_table(table, tmp)
    os.replace(tmp, path)
    return path


# ---------------------------------------------------------------------------
# The sharded plain-space walk
# ---------------------------------------------------------------------------

def _sharded_space_events(
        workload, space, model, chunk_size, max_points, seed, budget,
        stats, pruners, shards, pipeline_depth, start_chunk,
        max_chunks, tracer=NULL_TRACER) -> Iterator[tuple]:
    """The engine: yields ``("chunk", shard, (result, indices))`` for
    every feasible evaluated chunk / flush and ``("retired", shard, c)``
    when raw chunk ``c`` is fully absorbed (its result folded, or its
    survivors buffered in the shard's pruner).  Retires are strictly in
    walk order: the dense cursor that makes checkpoints resumable.

    ``shards`` is the list of ``_Shard``.  Unpruned shards run the
    pipeline (at most ``len(shards) * pipeline_depth`` chunks in flight,
    finished oldest-first); pruned shards feed synchronously.  At a
    ``max_chunks`` truncation the in-flight chunks are drained but
    pruner buffers are NOT (they belong in the checkpoint); at natural
    exhaustion the pruners drain too.  With an enabled ``tracer`` every
    chunk's dispatch->retire residency lands as a complete event on its
    shard's lane (``shard<s>``) and the in-flight depth is a gauge.
    """
    n_shards = len(shards)
    use_prune = pruners is not None
    cap = max(1, n_shards * max(1, pipeline_depth))
    inflight: deque = deque()
    traced = tracer.enabled

    def _finish_one():
        c, s, pending, idx, t_disp = inflight.popleft()
        res = _traced_finish(tracer, pending, track=f"shard{s}") \
            if traced else finish_chunk(pending)
        if traced:
            tracer.complete("chunk", t_disp, tracer.now_ns(),
                            cat="pipeline", track=f"shard{s}", chunk=c)
            tracer.gauge("pipeline.in_flight", len(inflight))
        if budget is not None:
            res, idx = apply_budget(res, idx, budget,
                                    stats=None if stats is None
                                    else stats[s])
            if traced and len(idx) < pending.n:
                tracer.counter("budget.killed", pending.n - len(idx))
        return c, s, ((res, idx) if len(idx) else None)

    completed = True
    chunks = timed_iter(
        iter_space_chunks(space, chunk_size=chunk_size,
                          max_points=max_points, seed=seed,
                          start_chunk=start_chunk, device="cpu"), tracer)
    for c, (cfg, idx) in enumerate(chunks, start=start_chunk):
        if max_chunks is not None and c - start_chunk >= max_chunks:
            completed = False
            break
        s = c % n_shards
        sh = shards[s]
        wl = sh.placed(workload)
        if traced:
            tracer.counter("sweep.points", len(idx))
        if use_prune:
            with sh.active():
                for res, fidx, _aux in pruners[s].feed(cfg, idx, wl):
                    yield "chunk", s, (res, fidx)
            yield "retired", s, c
            continue
        with sh.active():
            if traced:
                t_disp = tracer.now_ns()
                pending = _traced_dispatch(tracer, cfg, wl,
                                           sh.placed(model), chunk_size,
                                           track=f"shard{s}")
            else:
                t_disp = 0
                pending = dispatch_chunk(cfg, wl, sh.placed(model),
                                         pad_to=chunk_size)
        inflight.append((c, s, pending, idx, t_disp))
        if traced:
            tracer.gauge("pipeline.in_flight", len(inflight))
        while len(inflight) >= cap:
            fc, fs, out = _finish_one()
            if out is not None:
                yield "chunk", fs, out
            yield "retired", fs, fc
    while inflight:
        fc, fs, out = _finish_one()
        if out is not None:
            yield "chunk", fs, out
        yield "retired", fs, fc
    if use_prune and completed:
        for s in range(n_shards):
            with shards[s].active():
                for res, fidx, _aux in pruners[s].finish():
                    yield "chunk", s, (res, fidx)


def _make_pruners(shards, budget, chunk_size, model, stats, telemetry):
    return [TwoStagePruner(budget, chunk_size, sh.placed(model), stats[s],
                           telemetry=telemetry, track=f"shard{s}")
            for s, sh in enumerate(shards)]


def sharded_space_stream(
        workload, space=None, surrogate=None,
        chunk_size: int = DEFAULT_CHUNK_SIZE,
        max_points: int | None = None, seed: int = 0,
        budget: Budget | None = None,
        budget_stats: BudgetStats | None = None, prune: bool = True,
        shards: int | None = None, devices: Sequence | None = None,
        pipeline_depth: int = DEFAULT_PIPELINE_DEPTH,
        telemetry=None,
) -> Iterator[tuple]:
    """Sharded drop-in for ``dse.evaluate_space_streaming``: yields the
    same ``(chunk_result, flat_indices)`` pairs (every lane bit-identical
    to the single-process walk; unpruned chunk order follows the walk,
    pruned flush boundaries follow each shard's survivor re-packing).
    Per-shard budget telemetry is merged into ``budget_stats`` once the
    stream is exhausted."""
    tr = as_tracer(telemetry)
    home = _workload_device(workload)
    n_shards, devs = _resolve_for(shards, devices, home)
    lanes = _make_shards(n_shards, devs, home)
    model = as_cost_model(surrogate)
    use_prune = (budget is not None and prune
                 and bool(budget.config_constraints()))
    stats = [BudgetStats() for _ in range(n_shards)] \
        if budget is not None else None
    pruners = _make_pruners(lanes, budget, chunk_size, model, stats,
                            telemetry) if use_prune else None
    for kind, _s, payload in _sharded_space_events(
            workload, space, model, chunk_size, max_points, seed, budget,
            stats, pruners, lanes, pipeline_depth, 0, None, tracer=tr):
        if kind == "chunk":
            yield payload
    if budget_stats is not None and stats is not None:
        for st in stats:
            budget_stats.merge(st)


def sharded_pareto_front(
        workload, space=None,
        metrics: tuple = ("perf_per_area", "neg_energy_j"),
        surrogate=None, chunk_size: int = DEFAULT_CHUNK_SIZE,
        max_points: int | None = None, seed: int = 0,
        budget: Budget | None = None,
        budget_stats: BudgetStats | None = None, prune: bool = True,
        shards: int | None = None, devices: Sequence | None = None,
        pipeline_depth: int = DEFAULT_PIPELINE_DEPTH,
        checkpoint_dir: str | None = None, checkpoint_every: int = 64,
        checkpoint_keep: int = 3, csv_path: str | None = None,
        max_chunks: int | None = None,
        telemetry=None,
) -> tuple[ParetoArchive, AcceleratorConfig]:
    """Sharded, pipelined, durable ``dse.pareto_front_streaming``.

    Same return contract (merged archive + decoded front configs, on the
    workload's device) and a bit-identical front for any shard count.
    With ``checkpoint_dir`` the walk state is snapshotted every
    ``checkpoint_every`` retired chunks and the walk RESUMES from the
    latest checkpoint on restart; ``max_chunks`` stops the walk after
    that many chunks (checkpoint + partial front returned).
    ``csv_path`` streams the decoded merged front at every checkpoint
    and at completion.
    """
    tr = as_tracer(telemetry)
    home = _workload_device(workload)
    n_shards, devs = _resolve_for(shards, devices, home)
    lanes = _make_shards(n_shards, devs, home)
    model = as_cost_model(surrogate)
    use_prune = (budget is not None and prune
                 and bool(budget.config_constraints()))
    archives = [ParetoArchive(len(metrics)) for _ in range(n_shards)]
    stats = [BudgetStats() for _ in range(n_shards)] \
        if budget is not None else None
    ckpt = None
    cursor = 0
    pruner_states = None
    if checkpoint_dir is not None:
        ckpt = SweepCheckpointer(
            checkpoint_dir, every=checkpoint_every, keep=checkpoint_keep,
            signature=dict(
                kind="space", shards=n_shards, chunk_size=int(chunk_size),
                max_points=max_points, seed=int(seed),
                metrics=list(metrics), prune=bool(use_prune),
                budget=None if budget is None else budget.spec(),
                space=space_signature(space)))
        loaded = ckpt.load(telemetry=telemetry)
        if loaded is not None:
            cursor = int(loaded["cursor"])
            archives = [ParetoArchive.from_state(a)
                        for a in loaded["archives"]]
            if stats is not None and loaded.get("stats") is not None:
                stats = [BudgetStats.from_dict(d) for d in loaded["stats"]]
            pruner_states = loaded.get("pruners")
    pruners = None
    if use_prune:
        pruners = _make_pruners(lanes, budget, chunk_size, model, stats,
                                telemetry)
        if pruner_states is not None:
            for p, st, sh in zip(pruners, pruner_states, lanes):
                p.restore_state(st, sh.placed(workload))

    def _state() -> dict:
        st = dict(cursor=cursor,
                  archives=[a.state_dict() for a in archives])
        if stats is not None:
            st["stats"] = [s_.as_dict() for s_ in stats]
        if pruners is not None:
            st["pruners"] = [p.state_dict() for p in pruners]
        return st

    def _snapshot() -> None:
        if ckpt is not None:
            with tr.span("checkpoint", cursor=cursor):
                ckpt.save(cursor, _state(), telemetry=telemetry)
        if csv_path is not None:
            with tr.span("csv"):
                export_front_csv(csv_path,
                                 merge_archives(archives, len(metrics)),
                                 metrics, space=space)

    for kind, s, payload in _sharded_space_events(
            workload, space, model, chunk_size, max_points, seed, budget,
            stats, pruners, lanes, pipeline_depth, cursor,
            max_chunks, tracer=tr):
        if kind == "chunk":
            res, idx = payload
            with tr.span("archive"):
                archives[s].update(_objective_columns(res, metrics), idx)
        else:
            cursor = payload + 1
            if ckpt is not None and ckpt.due(cursor):
                _snapshot()
    _snapshot()
    if budget_stats is not None and stats is not None:
        for st in stats:
            budget_stats.merge(st)
    with tr.span("archive_merge"):
        merged = merge_archives(archives, len(metrics))
    return merged, space_points(merged.indices, space, home)


__all__ = [
    "DEFAULT_PIPELINE_DEPTH", "SweepCheckpointer", "export_front_csv",
    "export_front_parquet", "merge_archives", "merge_budget_stats",
    "resolve_shards", "shard_device", "sharded_pareto_front",
    "sharded_space_stream", "space_signature", "workloads_signature",
]
