"""Joint accelerator x model co-exploration (port of
``repro.core.coexplore``; QUIDAM / QAPPA-style).

The (model, accelerator-config) pair is the unit of exploration:

* the joint space is the mixed-radix product of a model axis (a sequence
  of ``ModelEntry``) and the accelerator space, the model the slowest
  digit (``arch.iter_joint_space_chunks``); by default chunks MIX models
  within a layer-count bucket, every lane gathering its own padded layer
  stack (``dse.evaluate_chunk(model_ids=...)``);
* the accuracy axis comes from ``accuracy.AccuracySurrogate``;
* per-model normalization: throughput in MACs/s per mm^2 and energy in
  pJ/MAC, so a big model is not penalized for its work per inference;
* the 3-objective front (accuracy, MACs/s/mm^2, -pJ/MAC) is kept by the
  streaming ``ParetoArchive``; memory stays O(chunk + front).

``coexplore_front(mix_models=True)`` equals ``mix_models=False`` (the
per-model walk) bit for bit, and ``prune=True`` equals ``prune=False``
under a budget: same front indices, objectives, budget counts and
per-(model, PE) bests.  The walk runs on the device of the models'
workloads (``default_model_set(device=...)``); chunks are decoded on the
host and go to the device with their evaluation.  The sharded,
pipelined and checkpointed walk (``shards=`` ... ``max_chunks=``),
budgeted search (``driver=``, ``repro_torch.core.search``) and
``telemetry=`` behave as the reference's, with fronts bit-identical to
the plain walk's.

``lightpe_claim`` checks the paper's claim on the sweep: per model, the
best LightPE beats the best INT16 on both hardware metrics within 1pp of
FP32 accuracy.
"""

from __future__ import annotations

from collections import deque
from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.accuracy import AccuracySurrogate, seeded_base_accuracy
from repro_torch.core.arch import (AcceleratorConfig, PE_TYPE_NAMES,
                                   config_rows, iter_joint_space_chunks,
                                   joint_space_points, joint_space_size)
from repro_torch.core.constraints import Budget, BudgetStats
from repro_torch.core.costmodel import CostModel, as_cost_model
from repro_torch.core.dse import (DEFAULT_CHUNK_SIZE, ParetoArchive,
                                  TwoStagePruner, _traced_dispatch,
                                  _traced_finish, dispatch_chunk,
                                  finish_chunk, fold_budget_chunk)
from repro_torch.core.ppa import PPAModels
from repro_torch.core.workloads import (Workload, acc_class_mix, layer_bucket,
                                        llm_decode, llm_moe, resnet_cifar,
                                        stack_workloads, transformer_gemm,
                                        vgg16, workload_layers, workload_macs)
from repro_torch.obs import as_tracer, timed_iter

# The joint objectives, all HIGHER-IS-BETTER (column order of the archive).
COEXPLORE_METRICS = ("accuracy", "macs_per_s_per_mm2", "neg_energy_per_mac_pj")


class ModelEntry(NamedTuple):
    """One point on the model axis: a workload plus its normalization
    scalar (forward MACs of one inference) and FP32 base accuracy;
    ``acc_mix`` (opt-in) is its ``ACC_CLASSES`` MAC mix."""
    name: str
    workload: Workload
    macs: float        # forward MACs of one inference (normalizer)
    base_acc: float    # FP32 top-1 (fraction; proxy for non-classifiers)
    acc_mix: tuple | None = None   # ACC_CLASSES MAC fractions (opt-in)


def model_entry(workload: Workload,
                base_acc: float | None = None,
                acc_classes: bool = False) -> ModelEntry:
    """Wrap a Workload for the model axis (per-inference MACs + seeded
    FP32 accuracy; ``acc_classes=True`` attaches its layer-class mix)."""
    macs = workload_macs(workload, per_inference=True)
    if base_acc is None:
        base_acc = seeded_base_accuracy(workload.name, macs)
    mix = acc_class_mix(workload) if acc_classes else None
    return ModelEntry(workload.name, workload, macs, float(base_acc), mix)


def default_model_set(batch: int = 1,
                      device: str | torch.device | None = None
                      ) -> tuple[ModelEntry, ...]:
    """The canonical 13-model axis: the paper's CNNs and their
    depth/width/resolution-scaled members, two seq-scaled transformer
    GEMMs, and three LLM serving members (Qwen3-32B decode at context
    8192, DeepSeek-MoE-16B decode, Phi-3.5-MoE decode) with layer-class
    accuracy mixes.  The zoo collapses to the layer buckets {16, 32, 64}.
    """
    tfm = dict(d_model=256, n_layers=6, n_heads=8, d_ff=1024, vocab=8192,
               batch=batch, device=device)
    entries = [model_entry(wl) for wl in (
        resnet_cifar(20, batch=batch, device=device),
        resnet_cifar(32, batch=batch, device=device),
        resnet_cifar(56, batch=batch, device=device),
        resnet_cifar(20, batch=batch, width_mult=2.0, device=device),
        resnet_cifar(20, batch=batch, resolution=16, device=device),
        resnet_cifar(20, batch=batch, resolution=224, device=device),
        vgg16("cifar10", batch=batch, device=device),
        vgg16("cifar10", batch=batch, width_mult=0.5, device=device),
        transformer_gemm(seq=256, **tfm),
        transformer_gemm(seq=1024, **tfm),
    )]
    entries += [model_entry(wl, acc_classes=True) for wl in (
        llm_decode("qwen3-32b", context=8192, batch=batch, device=device),
        llm_decode("deepseek-moe-16b", context=4096, batch=batch,
                   device=device),
        llm_moe("phi3.5-moe-42b-a6.6b", seq=512, batch=batch, mode="decode",
                device=device),
    )]
    return tuple(entries)


class JointDesignPoint(NamedTuple):
    """One decoded front member: the named (model, PE, config) triple,
    ``config`` mapping every ``AcceleratorConfig`` field to a scalar."""
    model: str
    pe_type: str
    config: dict


class CoexploreFront(NamedTuple):
    """Result of a joint sweep: the 3-objective archive plus what is
    needed to decode it back to named design points."""
    archive: ParetoArchive
    models: tuple                  # ModelEntry, the model axis (in order)
    space: dict | None             # accelerator space swept
    metrics: tuple                 # objective column names (higher-better)
    per_model_best: dict           # (model, pe_name) -> best-seen scalars
    points_evaluated: int
    buckets: tuple = ()            # (padded depth, model names) per group
    budget: Budget | None = None   # the deployment budget, if constrained
    budget_stats: BudgetStats | None = None  # kill counts / feasible share

    def decoded_front(self) -> tuple[JointDesignPoint, ...]:
        """The archive decoded to named ``(model, PE, config)`` points,
        index-aligned with ``archive.indices`` / ``archive.objectives``
        (decoded on the host: the rows are python scalars)."""
        mids, cfgs = joint_space_points(self.archive.indices, self.space,
                                        num_models=len(self.models),
                                        device="cpu")
        return tuple(
            JointDesignPoint(model=self.models[int(m)].name,
                             pe_type=row["pe_type_name"],
                             config={k: row[k]
                                     for k in AcceleratorConfig._fields})
            for m, row in zip(mids, config_rows(cfgs)))


def _joint_objectives(res, lane_acc: np.ndarray) -> np.ndarray:
    """(N, 3) higher-is-better objective matrix for one chunk.

    MACs-normalized: throughput = MACs/s/mm^2, energy = pJ/MAC — the
    per-model normalization that makes objectives comparable across
    workloads (res.macs is each lane's own network MAC count, so a mixed
    chunk normalizes every lane by its model for free).
    """
    lat = np.asarray(res.latency_s, np.float64)
    area = np.asarray(res.area_mm2, np.float64)
    energy = np.asarray(res.energy_j, np.float64)
    macs = np.asarray(res.macs, np.float64)
    mps_mm2 = macs / np.maximum(lat, 1e-12) / np.maximum(area, 1e-9)
    e_per_mac = energy / np.maximum(macs, 1.0) * 1e12
    return np.stack([lane_acc, mps_mm2, -e_per_mac], axis=-1)


def _update_per_model_best(best: dict, models: tuple, acc_matrix: np.ndarray,
                           mids: np.ndarray, codes: np.ndarray,
                           obj: np.ndarray) -> None:
    """Fold one chunk into the (model, PE-type) best-seen aggregates."""
    n_types = len(PE_TYPE_NAMES)
    for k in np.unique(mids * n_types + codes):
        m, code = divmod(int(k), n_types)
        sel = (mids == m) & (codes == code)
        entry = best.setdefault((models[m].name, PE_TYPE_NAMES[code]), dict(
            macs_per_s_per_mm2=-np.inf, energy_per_mac_pj=np.inf,
            accuracy=float(acc_matrix[m, code])))
        entry["macs_per_s_per_mm2"] = max(entry["macs_per_s_per_mm2"],
                                          float(obj[sel, 1].max()))
        entry["energy_per_mac_pj"] = min(entry["energy_per_mac_pj"],
                                         float(-obj[sel, 2].max()))


def _bucket_models(models: tuple, layer_buckets):
    """Group the model axis into layer-count buckets for the mixed walk.
    Returns ``(bucket_of, group_ids, stacked, local, buckets_meta)``: the
    stacked (M_b, L_b) workload per bucket, the
    walk's group order, and each model's position in its group's stack.
    """
    bucket_of = [layer_bucket(workload_layers(m.workload), layer_buckets)
                 for m in models]
    groups: dict[int, list[int]] = {}
    for i, b in enumerate(bucket_of):
        groups.setdefault(b, []).append(i)
    group_ids = tuple(tuple(groups[b]) for b in sorted(groups))
    stacked = {b: stack_workloads([models[i].workload for i in groups[b]],
                                  pad_to=b) for b in groups}
    # global model id -> position in its group's stack
    local = np.full(len(models), -1, np.int64)
    for b in groups:
        local[groups[b]] = np.arange(len(groups[b]))
    buckets_meta = tuple((b, tuple(models[i].name for i in groups[b]))
                         for b in sorted(groups))
    return bucket_of, group_ids, stacked, local, buckets_meta


def accuracy_matrix(models: Sequence[ModelEntry],
                    accuracy: AccuracySurrogate | None = None) -> np.ndarray:
    """(M, n_pe_types) accuracy constants of a model axis.

    The per-lane accuracy objective of any joint walk is the gather
    ``acc_matrix[model_id, pe_code]`` (capacity-scaled, calibration-aware).
    ``accuracy`` defaults to a fresh seeded ``AccuracySurrogate``; the
    arithmetic is the reference's host float64, so the matrix equals the
    reference's exactly.
    """
    accuracy = AccuracySurrogate() if accuracy is None else accuracy
    return np.stack([accuracy.predict_per_type(
        m.name, m.macs, m.base_acc,
        class_mix=getattr(m, "acc_mix", None)) for m in models])


class JointWalk(NamedTuple):
    """A planned joint (model x accelerator) chunk walk.

    The normalized chunk stream every walk driver consumes: for the same
    plan parameters every driver iterating ``chunks()`` visits
    the IDENTICAL chunk sequence.  Mixed-mode plans carry the layer-bucket
    grouping (one stacked workload per bucket); per-model plans walk one
    model at a time.
    """
    models: tuple
    space: dict | None
    chunk_size: int
    max_points: int | None
    seed: int
    mix_models: bool
    group_ids: tuple | None        # mixed: bucket -> global model id tuple
    bucket_of: tuple | None        # mixed: model id -> padded bucket depth
    stacked: dict | None           # mixed: bucket depth -> StackedWorkload
    local: np.ndarray | None       # mixed: global id -> position in stack
    buckets_meta: tuple = ()       # (padded depth, model names) per group

    def chunks(self, start_chunk: int = 0):
        """Yield ``(wl_key, workload, model_ids, mids, cfg, idx)`` from
        ``start_chunk`` on (resumable by index arithmetic); ``wl_key``
        names the workload (bucket depth when mixing, model id
        otherwise).  The configs are decoded on the host; the dispatch
        takes them to the workload's device."""
        if self.mix_models:
            for mids, cfg, idx in iter_joint_space_chunks(
                    self.space, num_models=len(self.models),
                    chunk_size=self.chunk_size, max_points=self.max_points,
                    seed=self.seed, model_groups=self.group_ids,
                    start_chunk=start_chunk, device="cpu"):
                b = self.bucket_of[int(mids[0])]
                yield b, self.stacked[b], self.local[mids], mids, cfg, idx
            return
        for m, cfg, idx in iter_joint_space_chunks(
                self.space, num_models=len(self.models),
                chunk_size=self.chunk_size, max_points=self.max_points,
                seed=self.seed, group_by_model=True,
                start_chunk=start_chunk, device="cpu"):
            mids = np.full(len(idx), int(m), np.int64)
            yield int(m), self.models[m].workload, None, mids, cfg, idx

    def workload_for(self, wl_key):
        """The (stacked) workload behind a ``chunks()`` key: checkpoint
        restore of an interrupted pruner buffer."""
        if wl_key is None:
            return None
        return self.stacked[int(wl_key)] if self.mix_models \
            else self.models[int(wl_key)].workload


def plan_joint_walk(models: Sequence[ModelEntry],
                    space: dict | None = None,
                    chunk_size: int = DEFAULT_CHUNK_SIZE,
                    max_points: int | None = None,
                    seed: int = 0,
                    mix_models: bool = True,
                    layer_buckets: Sequence[int] | None = None
                    ) -> JointWalk:
    """Plan the joint walk once: bucket the model axis (mixed mode) and
    freeze every enumeration parameter, so multiple drivers — or repeated
    passes of one driver — replay the exact same chunk stream."""
    models = tuple(models)
    bucket_of = group_ids = stacked = local = None
    buckets_meta = ()
    if mix_models:
        bucket_of, group_ids, stacked, local, buckets_meta = \
            _bucket_models(models, layer_buckets)
    return JointWalk(models=models, space=space, chunk_size=int(chunk_size),
                     max_points=max_points, seed=int(seed),
                     mix_models=bool(mix_models), group_ids=group_ids,
                     bucket_of=None if bucket_of is None else tuple(bucket_of),
                     stacked=stacked, local=local, buckets_meta=buckets_meta)


def coexplore_front(
        models: Sequence[ModelEntry],
        space: dict | None = None,
        surrogate: PPAModels | CostModel | str | None = None,
        accuracy: AccuracySurrogate | None = None,
        chunk_size: int = DEFAULT_CHUNK_SIZE,
        max_points: int | None = None,
        seed: int = 0,
        mix_models: bool = True,
        layer_buckets: Sequence[int] | None = None,
        budget: Budget | None = None,
        prune: bool = True,
        shards: int | None = None,
        devices=None,
        pipeline_depth: int | None = None,
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 64,
        csv_path: str | None = None,
        max_chunks: int | None = None,
        driver=None,
        telemetry=None) -> CoexploreFront:
    """Stream the joint (model x accelerator) space into a 3-objective
    non-dominated archive, on the device of the models' workloads.

    The default walk buckets the models to canonical padded depths
    (``workloads.layer_bucket``; ``layer_buckets`` overrides the sizes),
    stacks each bucket's workloads into (M, L) fields, and lets chunks mix
    models within a bucket.  Padding is exact, so the front equals the
    per-model walk's (``mix_models=False``) bit for bit.

    ``surrogate`` switches clock/area/leakage to the fitted PPA models;
    ``accuracy`` defaults to a fresh seeded ``AccuracySurrogate``.
    ``max_points`` subsamples the JOINT space (the same points in both
    walks).  ``budget`` masks infeasible lanes before the archive and the
    per-(model, PE) bests see them (the front of the FEASIBLE subset,
    equal to post-hoc filtering); budgets with config-stage bounds run
    two-stage (``dse.TwoStagePruner``) unless ``prune=False``, with the
    same front, bests, evaluated counts and config-stage kills.
    ``points_evaluated`` counts every visited (pre-mask) lane.

    Any of ``shards`` / ``devices`` / ``pipeline_depth`` /
    ``checkpoint_dir`` (with ``checkpoint_every``) / ``csv_path`` /
    ``max_chunks`` engages the sharded, pipelined, checkpointable walk
    (``_sharded_coexplore_front``): the same point set and a bit-identical
    front.  ``telemetry=`` (a ``repro_torch.obs.Tracer``) times the walk's
    phases and counts points and kills without touching a value.

    ``driver`` (a ``search.SearchDriver`` or a registered name,
    ``"evolve"`` / ``"halving"``) replaces enumeration with budgeted
    search (``search.search_front``; ``max_points`` becomes the
    full-evaluation budget).  ``csv_path``, ``max_chunks`` and
    ``mix_models=False`` have no meaning for a search and raise with it.
    """
    models = tuple(models)
    if not models:
        raise ValueError("need at least one ModelEntry on the model axis")
    if driver is not None:
        unsupported = [kw for kw, v in (("csv_path", csv_path),
                                        ("max_chunks", max_chunks))
                       if v is not None]
        if not mix_models:
            unsupported.append("mix_models=False")
        if unsupported:
            raise ValueError(
                f"driver= is incompatible with {', '.join(unsupported)}: "
                f"a budgeted search has no enumeration cursor to stream "
                f"or truncate and always mixes models; drop the kwarg or "
                f"use search_front directly")
        from repro_torch.core.search import search_front
        return search_front(
            models, space=space, driver=driver, surrogate=surrogate,
            accuracy=accuracy, chunk_size=chunk_size,
            max_evals=(joint_space_size(space, len(models))
                       if max_points is None else int(max_points)),
            seed=seed, budget=budget, layer_buckets=layer_buckets,
            shards=shards, devices=devices, pipeline_depth=pipeline_depth,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            telemetry=telemetry)
    if (shards is not None or devices is not None
            or checkpoint_dir is not None or csv_path is not None
            or max_chunks is not None):
        return _sharded_coexplore_front(
            models, space=space, surrogate=surrogate, accuracy=accuracy,
            chunk_size=chunk_size, max_points=max_points, seed=seed,
            mix_models=mix_models, layer_buckets=layer_buckets,
            budget=budget, prune=prune, shards=shards, devices=devices,
            pipeline_depth=pipeline_depth, checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, csv_path=csv_path,
            max_chunks=max_chunks, telemetry=telemetry)
    tr = as_tracer(telemetry)
    cost_model = as_cost_model(surrogate)
    acc_matrix = accuracy_matrix(models, accuracy)
    walk = plan_joint_walk(models, space=space, chunk_size=chunk_size,
                           max_points=max_points, seed=seed,
                           mix_models=mix_models,
                           layer_buckets=layer_buckets)
    archive = ParetoArchive(len(COEXPLORE_METRICS))
    per_model_best: dict[tuple[str, str], dict] = {}
    stats = BudgetStats() if budget is not None else None
    engage = (budget is not None and prune
              and bool(budget.config_constraints()))
    pruner = TwoStagePruner(budget, chunk_size, cost_model, stats,
                            telemetry=telemetry) if engage else None
    total = 0

    def _fold_chunk(res, idx, mids, codes):
        """One evaluated chunk -> (mask by budget) -> archive + bests;
        row masking commutes with both, so the walks stay equal."""
        lane_acc = acc_matrix[mids, codes]
        obj = _joint_objectives(res, lane_acc)
        obj, idx, (mids, codes) = fold_budget_chunk(
            archive, obj, idx, result=res, budget=budget, accuracy=lane_acc,
            stats=stats, aux=(mids, codes), telemetry=tr)
        _update_per_model_best(per_model_best, models, acc_matrix,
                               mids, codes, obj)

    def _fold_flush(res, idx, aux):
        """One fully-feasible two-stage flush -> archive + bests."""
        obj = _joint_objectives(res, aux["accuracy"])
        fold_budget_chunk(archive, obj, idx, telemetry=tr)
        _update_per_model_best(per_model_best, models, acc_matrix,
                               aux["mids"], aux["codes"], obj)

    for _, wl, model_ids, mids, cfg, idx in timed_iter(walk.chunks(), tr):
        codes = np.asarray(cfg.pe_type).astype(np.int64)
        total += len(idx)
        if tr.enabled:
            tr.counter("sweep.points", len(idx))
        if not engage:
            pending = _traced_dispatch(tr, cfg, wl, cost_model, chunk_size,
                                       model_ids=model_ids)
            _fold_chunk(_traced_finish(tr, pending), idx, mids, codes)
            continue
        aux = dict(accuracy=acc_matrix[mids, codes], mids=mids, codes=codes)
        for out in pruner.feed(cfg, idx, wl, model_ids=model_ids, aux=aux):
            _fold_flush(*out)
    if engage:
        for out in pruner.finish():
            _fold_flush(*out)
    return CoexploreFront(archive=archive, models=models, space=space,
                          metrics=COEXPLORE_METRICS,
                          per_model_best=per_model_best,
                          points_evaluated=total, buckets=walk.buckets_meta,
                          budget=budget, budget_stats=stats)


def _merge_best(dest: dict, src: dict) -> None:
    """Fold one shard's (model, PE-type) best-seen aggregates into the
    merged dict: max / min are exact, so the merge equals the
    single-process fold bit for bit."""
    for key, e in src.items():
        d = dest.get(key)
        if d is None:
            dest[key] = dict(e)
        else:
            d["macs_per_s_per_mm2"] = max(d["macs_per_s_per_mm2"],
                                          e["macs_per_s_per_mm2"])
            d["energy_per_mac_pj"] = min(d["energy_per_mac_pj"],
                                         e["energy_per_mac_pj"])


def _sharded_coexplore_front(
        models: tuple, space, surrogate, accuracy, chunk_size, max_points,
        seed, mix_models, layer_buckets, budget, prune, shards, devices,
        pipeline_depth, checkpoint_dir, checkpoint_every, csv_path,
        max_chunks, telemetry=None) -> CoexploreFront:
    """The sharded / pipelined / durable joint walk behind
    ``coexplore_front``.

    The default walk's chunk sequence, dealt round-robin across S shards;
    each shard folds into its own archive, (model, PE) bests, counters
    and (when the budget engages two-stage pruning) its own
    ``TwoStagePruner``, and runs its chunks on its own device and CUDA
    stream (``repro_torch.core.shard``).  Unpruned chunks are pipelined:
    up to ``shards * pipeline_depth`` in flight, finished oldest-first.
    Per-shard state merges exactly (archive reduction, max / min bests,
    additive stats), so the front is bit-identical to the plain walk's.

    Every ``checkpoint_every`` retired chunks the complete per-shard
    state (archives, bests, counters, stats, pruner buffers and their
    active bucket / model) and the cursor are written atomically; an
    existing checkpoint in ``checkpoint_dir`` resumes the walk from its
    cursor and reproduces the uninterrupted front.  ``max_chunks`` stops
    the walk after a final checkpoint.
    """
    from repro_torch.core import shard as _shard
    tr = as_tracer(telemetry)
    cost_model = as_cost_model(surrogate)
    acc_matrix = accuracy_matrix(models, accuracy)
    home = models[0].workload.layers.H.device
    n_shards, devs = _shard._resolve_for(shards, devices, home)
    lanes = _shard._make_shards(n_shards, devs, home)
    depth = _shard.DEFAULT_PIPELINE_DEPTH if pipeline_depth is None \
        else pipeline_depth
    engage = (budget is not None and prune
              and bool(budget.config_constraints()))
    archives = [ParetoArchive(len(COEXPLORE_METRICS))
                for _ in range(n_shards)]
    bests: list[dict] = [{} for _ in range(n_shards)]
    totals = [0] * n_shards
    stats = [BudgetStats() for _ in range(n_shards)] \
        if budget is not None else None

    walk = plan_joint_walk(models, space=space, chunk_size=chunk_size,
                           max_points=max_points, seed=seed,
                           mix_models=mix_models,
                           layer_buckets=layer_buckets)

    ckpt = None
    cursor = 0
    pruner_states = wl_keys = None
    if checkpoint_dir is not None:
        ckpt = _shard.SweepCheckpointer(
            checkpoint_dir, every=checkpoint_every,
            signature=dict(
                kind="joint", mix=bool(mix_models), shards=n_shards,
                chunk_size=int(chunk_size), max_points=max_points,
                seed=int(seed), metrics=list(COEXPLORE_METRICS),
                prune=bool(engage),
                budget=None if budget is None else budget.spec(),
                space=_shard.space_signature(space),
                models=[m.name for m in models],
                workloads=_shard.workloads_signature(models)))
        loaded = ckpt.load(telemetry=telemetry)
        if loaded is not None:
            cursor = int(loaded["cursor"])
            archives = [ParetoArchive.from_state(a)
                        for a in loaded["archives"]]
            bests = [{(m, pe): dict(e) for m, pe, e in shard_best}
                     for shard_best in loaded["best"]]
            totals = [int(t) for t in loaded["totals"]]
            if stats is not None and loaded.get("stats") is not None:
                stats = [BudgetStats.from_dict(d) for d in loaded["stats"]]
            pruner_states = loaded.get("pruners")
            wl_keys = loaded.get("wl_keys")
    pruners = None
    if engage:
        pruners = [TwoStagePruner(budget, chunk_size,
                                  sh.placed(cost_model), stats[s],
                                  telemetry=telemetry, track=f"shard{s}")
                   for s, sh in enumerate(lanes)]
        if pruner_states is not None:
            for s, (p, st) in enumerate(zip(pruners, pruner_states)):
                k = wl_keys[s] if wl_keys is not None else None
                wl = walk.workload_for(k)
                p.restore_state(st, None if wl is None
                                else lanes[s].placed(wl))
    active_keys: list = list(wl_keys) if wl_keys is not None \
        else [None] * n_shards

    def _fold(s, res, idx, mids, codes):
        lane_acc = acc_matrix[mids, codes]
        obj = _joint_objectives(res, lane_acc)
        totals[s] += len(idx)
        obj, idx, (mids, codes) = fold_budget_chunk(
            archives[s], obj, idx, result=res, budget=budget,
            accuracy=lane_acc, stats=None if stats is None else stats[s],
            aux=(mids, codes), telemetry=tr)
        _update_per_model_best(bests[s], models, acc_matrix, mids,
                               codes, obj)

    def _fold_flush(s, res, idx, aux):
        obj = _joint_objectives(res, aux["accuracy"])
        fold_budget_chunk(archives[s], obj, idx, telemetry=tr)
        _update_per_model_best(bests[s], models, acc_matrix,
                               aux["mids"], aux["codes"], obj)

    def _state() -> dict:
        st = dict(cursor=cursor,
                  archives=[a.state_dict() for a in archives],
                  best=[[[m, pe, dict(e)] for (m, pe), e in b.items()]
                        for b in bests],
                  totals=list(totals))
        if stats is not None:
            st["stats"] = [s_.as_dict() for s_ in stats]
        if pruners is not None:
            st["pruners"] = [p.state_dict() for p in pruners]
            st["wl_keys"] = list(active_keys)
        return st

    def _merged_archive() -> ParetoArchive:
        return _shard.merge_archives(archives, len(COEXPLORE_METRICS))

    def _snapshot() -> None:
        if ckpt is not None:
            with tr.span("checkpoint", cursor=cursor):
                ckpt.save(cursor, _state(), telemetry=telemetry)
        if csv_path is not None:
            with tr.span("csv"):
                _shard.export_front_csv(csv_path, _merged_archive(),
                                        COEXPLORE_METRICS, space=space,
                                        models=models)

    start = cursor            # cursor advances as chunks retire
    inflight: deque = deque()
    cap = max(1, n_shards * max(1, depth))
    completed = True
    traced = tr.enabled
    t_disp: dict[int, int] = {}

    def _finish_one() -> int:
        c, s, pending, idx, mids, codes = inflight.popleft()
        res = _traced_finish(tr, pending, track=f"shard{s}") \
            if traced else finish_chunk(pending)
        if traced:
            tr.complete("chunk", t_disp.pop(c), tr.now_ns(), cat="pipeline",
                        track=f"shard{s}", chunk=c)
            tr.gauge("pipeline.in_flight", len(inflight))
        _fold(s, res, idx, mids, codes)
        return c

    def _retire(c: int) -> None:
        nonlocal cursor
        cursor = c + 1
        if ckpt is not None and ckpt.due(cursor):
            _snapshot()

    for c, (wl_key, wl, model_ids, mids, cfg, idx) in enumerate(
            timed_iter(walk.chunks(start), tr), start=start):
        if max_chunks is not None and c - start >= max_chunks:
            completed = False
            break
        s = c % n_shards
        sh = lanes[s]
        wl = sh.placed(wl)
        codes = np.asarray(cfg.pe_type).astype(np.int64)
        if traced:
            tr.counter("sweep.points", len(idx))
        if engage:
            active_keys[s] = wl_key
            totals[s] += len(idx)
            aux = dict(accuracy=acc_matrix[mids, codes], mids=mids,
                       codes=codes)
            with sh.active():
                for out in pruners[s].feed(cfg, idx, wl,
                                           model_ids=model_ids, aux=aux):
                    _fold_flush(s, *out)
            _retire(c)
            continue
        with sh.active():
            if traced:
                t_disp[c] = tr.now_ns()
                pending = _traced_dispatch(tr, cfg, wl,
                                           sh.placed(cost_model),
                                           chunk_size, model_ids=model_ids,
                                           track=f"shard{s}")
            else:
                pending = dispatch_chunk(cfg, wl, sh.placed(cost_model),
                                         pad_to=chunk_size,
                                         model_ids=model_ids)
        inflight.append((c, s, pending, idx, mids, codes))
        if traced:
            tr.gauge("pipeline.in_flight", len(inflight))
        while len(inflight) >= cap:
            _retire(_finish_one())
    while inflight:
        _retire(_finish_one())
    if engage and completed:
        for s in range(n_shards):
            with lanes[s].active():
                for out in pruners[s].finish():
                    _fold_flush(s, *out)
    _snapshot()

    merged_best: dict = {}
    for b in bests:
        _merge_best(merged_best, b)
    merged_stats = _shard.merge_budget_stats(stats) \
        if stats is not None else None
    with tr.span("archive_merge"):
        merged = _merged_archive()
    return CoexploreFront(archive=merged, models=models,
                          space=space, metrics=COEXPLORE_METRICS,
                          per_model_best=merged_best,
                          points_evaluated=sum(totals),
                          buckets=walk.buckets_meta, budget=budget,
                          budget_stats=merged_stats)


def lightpe_claim(front: CoexploreFront) -> dict:
    """The paper's qualitative claim (Figs. 4-6 style), checked per model:
    some LightPE beats INT16's per-type BESTS on both hardware metrics —
    best MACs/s/mm^2 and lowest pJ/MAC, each aggregated over all sampled
    configs of that PE type — while staying within 1pp of FP32 accuracy.

    Note this is a best-of-aggregate comparison (what a streaming sweep
    can compute), not a proof of pointwise dominance: the best-throughput
    and best-energy LightPE configs may differ.  Under a ``budget`` the
    aggregates cover FEASIBLE sampled designs only — the claim is then
    evaluated within the deployment envelope.  A model whose sampled
    points include no INT16 or no FP32 design is *indeterminate*
    (``ok=None``) and excluded from ``holds``; ``indeterminate`` counts
    them.  ``holds`` is False when no model is determinate.
    """
    per_model, oks = {}, []
    for entry in front.models:
        int16 = front.per_model_best.get((entry.name, "int16"))
        fp32 = front.per_model_best.get((entry.name, "fp32"))
        if int16 is None or fp32 is None:
            missing = [pe for pe, b in (("int16", int16), ("fp32", fp32))
                       if b is None]
            per_model[entry.name] = dict(
                ok=None, note=f"no {'/'.join(missing)} design sampled "
                              "for this model — indeterminate")
            continue
        verdicts = {}
        for lp in ("lightpe1", "lightpe2"):
            b = front.per_model_best.get((entry.name, lp))
            if b is None:
                continue
            beats = (b["macs_per_s_per_mm2"] > int16["macs_per_s_per_mm2"]
                     and b["energy_per_mac_pj"] < int16["energy_per_mac_pj"])
            acc_gap_pp = 100.0 * (fp32["accuracy"] - b["accuracy"])
            verdicts[lp] = dict(beats_int16_bests=bool(beats),
                                acc_gap_vs_fp32_pp=acc_gap_pp,
                                within_1pp=bool(acc_gap_pp <= 1.0))
        if not verdicts:
            per_model[entry.name] = dict(
                ok=None, note="no LightPE design sampled for this model "
                              "— indeterminate")
            continue
        ok = any(v["beats_int16_bests"] and v["within_1pp"]
                 for v in verdicts.values())
        per_model[entry.name] = dict(ok=bool(ok), **verdicts)
        oks.append(ok)
    return dict(holds=bool(oks) and all(oks),
                indeterminate=sum(v["ok"] is None
                                  for v in per_model.values()),
                per_model=per_model,
                statement="best LightPE beats best INT16 on perf/area and "
                          "energy within 1pp of FP32 accuracy")


def coexplore_report(front: CoexploreFront) -> dict:
    """Decode the joint front back to named (model, PE, config) points.

    Returns ``points`` (one dict per archive member: model name, PE-type
    name, decoded config fields, the three objectives), ``front_counts``
    (per model / per PE-type membership), and ``claim`` (``lightpe_claim``).
    A constrained sweep additionally gets a ``"budget"`` section: the
    active bounds, evaluated/feasible counts, the feasible fraction, the
    ``pruned`` lane count, and per-constraint kill counts.  Kill counts
    are independent per constraint (a lane violating two bounds is
    killed by both) — but under the default two-stage walk the
    WORKLOAD-stage bounds are only checked against config-feasible
    survivors, so their counts are not comparable to a ``prune=False``
    run's; config-stage counts always match post-hoc filtering exactly.
    """
    points = []
    for i, p in enumerate(front.decoded_front()):
        acc, mps, neg_e = front.archive.objectives[i]
        points.append(dict(
            model=p.model,
            pe_type=p.pe_type,
            accuracy=float(acc),
            macs_per_s_per_mm2=float(mps),
            energy_per_mac_pj=float(-neg_e),
            config=p.config,
            joint_index=int(front.archive.indices[i]),
        ))
    by_model: dict[str, int] = {}
    by_pe: dict[str, int] = {}
    for p in points:
        by_model[p["model"]] = by_model.get(p["model"], 0) + 1
        by_pe[p["pe_type"]] = by_pe.get(p["pe_type"], 0) + 1
    rep = dict(
        points=points,
        front_size=len(points),
        points_evaluated=front.points_evaluated,
        space_size=joint_space_size(front.space, len(front.models)),
        metrics=list(front.metrics),
        front_counts=dict(by_model=by_model, by_pe_type=by_pe),
        layer_buckets=[dict(depth=b, models=list(names))
                       for b, names in front.buckets],
        claim=lightpe_claim(front),
    )
    if front.budget is not None:
        rep["budget"] = dict(spec=front.budget.spec(),
                             **front.budget_stats.as_dict())
    return rep
