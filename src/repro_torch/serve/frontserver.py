"""Pareto-front-as-a-service: a coalesced budget-query engine (port of
``repro.serve.frontserver``).

Clients submit ``constraints.Budget`` queries against a
fixed (model set, accelerator space, cost-model backend) target and get
a ``FrontResponse`` back — the constrained Pareto archive plus the
context to decode it (``decoded_front()``) — at interactive latency.
Three compounding mechanisms amortize the sweep cost:

**Query coalescing.**  All queries admitted while a walk is live share
ONE chunk walk (``coexplore.plan_joint_walk`` — the identical chunk
stream every other driver uses) through the async
``dispatch_chunk``/``finish_chunk`` pipeline (on a card the next chunk
is queued on the stream while the current one's folds run on the host).  Evaluation is shared;
per-query work is only the host-side ``Budget.feasibility`` mask and a
per-query ``ParetoArchive`` fold (``dse.fold_budget_chunk`` — the same
fold a standalone constrained walk runs).  Q concurrent queries thus
cost ~1 sweep instead of Q, and each query's front is **bit-identical**
(indices, objectives, row order) to its standalone
``coexplore_front(budget=..., prune=False)`` run: same chunk sequence,
same host arithmetic, same masked (obj, idx) stream into the archive.

**Mid-sweep joins.**  A query arriving while the walk is at chunk k
joins at the current cursor: the walk keeps a replay buffer of every
evaluated chunk's (objectives, indices, ``BudgetColumns``, accuracies)
— O(points visited) host memory, dropped when the walk completes — and
the joiner folds that prefix first, then rides the remaining chunks.
The replayed fold reads the identical host columns the live fold read,
so a joiner's front is bit-identical to a from-scratch sweep too.

**Warm front cache.**  ``FrontCache`` is an LRU keyed on the target
signature (``shard.space_signature`` + model names + backend fingerprint
+ accuracy-matrix digest + walk parameters) times a canonical budget
key.  Each completed walk stores the UNCONSTRAINED superset archive
together with the budget-readable columns + accuracies of its front
rows; each completed query stores its per-budget front.  A repeat query
(same budget spec) is served from its cached archive with zero chunk
evaluations.  A new budget is served from the superset when every
superset-front point is feasible under it — then the constrained front
equals the unconstrained front exactly (any point outside the superset
front is dominated by a superset-front point, which is feasible, so it
cannot enter the constrained front; the walk here never prunes
config-stage lanes, which is what makes this exact) — otherwise it
falls back to joining a (possibly fresh) coalesced sweep.  Cache-served
responses carry ``served_from="cache:repeat"`` / ``"cache:superset"``;
superset hits have no per-constraint kill statistics
(``budget_stats=None``) because no lane was ever masked.

**Admission policy.**  The submission queue is a bounded
``collections.deque``: past ``max_queue`` pending queries, ``submit``
REJECTS immediately.  A query may carry a ``deadline_s``; if admission
happens after the deadline the query EXPIRES without costing a fold.
``telemetry=`` (a ``repro_torch.obs.Tracer``) threads the serving
histograms through the scheduler: per-query queue latency
(``serve.queue_s``) and end-to-end latency (``serve.request_s``, both
with p50/p99), plus ``serve.front.*`` counters (chunk evals, cache
hits/misses, joins, rejections).

Typical use::

    server = FrontServer(default_model_set(), telemetry=tracer)
    q1 = server.submit(Budget(area_mm2=2.0))
    q2 = server.submit(Budget(power_mw=250.0))      # coalesces with q1
    server.run()                                    # ~1 sweep total
    for p in q1.response.decoded_front(): ...
    server.query(Budget(area_mm2=2.0))              # cache: 0 chunk evals
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import time
from collections import OrderedDict, deque
from typing import Deque, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.coexplore import (COEXPLORE_METRICS, CoexploreFront,
                                        ModelEntry, _joint_objectives,
                                        accuracy_matrix, plan_joint_walk)
from repro_torch.core.constraints import Budget, BudgetColumns, BudgetStats
from repro_torch.core.costmodel import as_cost_model
from repro_torch.core.dse import (DEFAULT_CHUNK_SIZE, ParetoArchive,
                                  chunk_dominators,
                                  _traced_dispatch, _traced_finish,
                                  fold_budget_chunk)
from repro_torch.core.shard import space_signature, workloads_signature
from repro_torch.device import host
from repro_torch.obs import as_tracer

# Query lifecycle states.
QUEUED, RUNNING, DONE, REJECTED, EXPIRED = (
    "queued", "running", "done", "rejected", "expired")

# Dispatch-ahead depth of the shared walk: the next chunk computes on
# device while the current one's per-query host folds run (the same
# double-buffering the sharded pipeline uses).
WALK_PIPELINE_DEPTH = 2


def _digest(*arrays) -> str:
    """Short stable content hash of host arrays (cache fingerprints)."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a))
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()[:16]


def _param_leaves(tree):
    """The leaves of a parameter tree in a fixed order (dict keys sorted,
    sequences in order), each as host float32."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _param_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _param_leaves(v)
    elif tree is not None:
        yield host(tree).astype(np.float32) if torch.is_tensor(tree) \
            else np.asarray(tree, np.float32)


def backend_signature(model) -> dict:
    """Fingerprint of a resolved ``CostModel``: registry name plus a
    content hash of the host float32 bytes of its fitted parameters in a
    fixed key order, so two different surrogate FITS (same name,
    different coefficients, e.g. one on the CPU and one on a card that
    differ in one bit) never share cache entries."""
    leaves = list(_param_leaves(model.ppa_params))
    return dict(name=model.name,
                params=_digest(*leaves) if leaves else "")


def budget_key(budget: Budget | None) -> str:
    """Canonical cache key of a budget: the sorted active-bound spec.
    ``None`` and a bound-free ``Budget()`` both map to ``"unconstrained"``
    — they mask nothing, so they share the superset front exactly."""
    if budget is None or not budget.active:
        return "unconstrained"
    return json.dumps(budget.spec(), sort_keys=True)


@dataclasses.dataclass
class CacheEntry:
    """One cached front: archive state + enough context to re-check
    feasibility of the front rows under future budgets (superset entries
    only — ``feas``/``accuracy`` are index-aligned with the archive
    rows)."""
    signature: dict
    budget_spec: dict | None
    archive_state: dict
    points_evaluated: int
    stats: dict | None = None
    feas: BudgetColumns | None = None
    accuracy: np.ndarray | None = None

    def state_dict(self) -> dict:
        """Checkpoint-manager-serializable form (plain dicts + arrays)."""
        return dict(signature=self.signature,
                    budget_spec=self.budget_spec,
                    archive_state=self.archive_state,
                    points_evaluated=int(self.points_evaluated),
                    stats=self.stats,
                    feas=None if self.feas is None
                    else self.feas.state_dict(),
                    accuracy=self.accuracy)

    @classmethod
    def from_state(cls, state: dict) -> "CacheEntry":
        return cls(signature=dict(state["signature"]),
                   budget_spec=state.get("budget_spec"),
                   archive_state=dict(state["archive_state"]),
                   points_evaluated=int(state["points_evaluated"]),
                   stats=state.get("stats"),
                   feas=None if state.get("feas") is None
                   else BudgetColumns.from_state(state["feas"]),
                   accuracy=None if state.get("accuracy") is None
                   else np.asarray(state["accuracy"]))


class FrontCache:
    """LRU of warm front state, keyed (target signature, budget key).

    ``capacity`` counts entries (a target's superset and each of its
    per-budget fronts are separate entries).  Lookup verifies the FULL
    stored signature against the requesting server's — a digest
    collision or a stale entry from a different target raises
    ``ValueError`` instead of serving a wrong front (the
    ``SweepCheckpointer`` signature-mismatch contract).
    """

    def __init__(self, capacity: int = 16):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self._entries: OrderedDict[tuple[str, str], CacheEntry] = \
            OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def target_key(signature: dict) -> str:
        """Short digest of the target signature (the dict key half; the
        full signature is stored in the entry and re-verified on every
        lookup, so a digest collision fails loudly instead of serving a
        wrong front)."""
        blob = json.dumps(signature, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()[:16]

    def _get(self, tkey: str, bkey: str,
             signature: dict) -> CacheEntry | None:
        e = self._entries.get((tkey, bkey))
        if e is None:
            return None
        if e.signature != signature:
            raise ValueError(
                f"front-cache entry under this target key was written by a "
                f"different target: stored signature {e.signature!r} != "
                f"expected {signature!r} — refusing to serve a wrong front")
        self._entries.move_to_end((tkey, bkey))
        return e

    def lookup(self, signature: dict, budget: Budget | None):
        """Resolve a query against the cache.

        Returns ``(kind, archive, entry)`` — ``kind`` is ``"repeat"``
        (this exact budget spec was served before; its archive replays
        verbatim, stats included) or ``"superset"`` (every
        unconstrained-front row is feasible under ``budget``, so the
        superset archive IS the constrained front) — or ``None`` on a
        miss.  Hit/miss counters accumulate on the cache.
        """
        tkey = self.target_key(signature)
        bkey = budget_key(budget)
        e = self._get(tkey, bkey, signature)
        if e is not None:
            self.hits += 1
            return "repeat", ParetoArchive.from_state(e.archive_state), e
        if bkey != "unconstrained":
            sup = self._get(tkey, "unconstrained", signature)
            if sup is not None and sup.feas is not None:
                mask, _ = budget.feasibility(sup.feas,
                                             accuracy=sup.accuracy)
                if mask.all():
                    self.hits += 1
                    return ("superset",
                            ParetoArchive.from_state(sup.archive_state), sup)
        self.misses += 1
        return None

    def store(self, signature: dict, budget: Budget | None,
              archive: ParetoArchive, points_evaluated: int,
              stats: dict | None = None,
              feas: BudgetColumns | None = None,
              accuracy: np.ndarray | None = None) -> None:
        """Insert/refresh one front; evicts least-recently-used past
        ``capacity``."""
        key = (self.target_key(signature), budget_key(budget))
        self._entries[key] = CacheEntry(
            signature=dict(signature),
            budget_spec=None if budget is None else budget.spec(),
            archive_state=archive.state_dict(),
            points_evaluated=int(points_evaluated),
            stats=stats, feas=feas,
            accuracy=None if accuracy is None else np.asarray(accuracy))
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)

    def save(self, ckpt_dir: str, telemetry=None) -> str:
        """Persist every entry (LRU order preserved) through
        ``repro_torch.checkpoint.manager`` — warm fronts survive process
        restarts (atomic tmp+rename, arrays sidecar'd as .npy)."""
        from repro_torch.checkpoint import manager as _ckpt
        entries = [[tkey, bkey, e.state_dict()]
                   for (tkey, bkey), e in self._entries.items()]
        return _ckpt.save_state(
            ckpt_dir, len(self._entries),
            dict(kind="frontcache", capacity=int(self.capacity),
                 entries=entries),
            keep=1, telemetry=telemetry)

    def load(self, ckpt_dir: str, telemetry=None) -> int:
        """Restore entries saved by ``save`` into this cache (merged in
        saved LRU order on top of anything already present; evicts past
        ``capacity`` as usual).  Returns the number of entries restored.

        Every entry is re-verified: its stored FULL signature must
        re-digest to the key it was filed under — a corrupted or
        hand-edited snapshot raises instead of poisoning lookups (the
        same loud-failure contract ``lookup`` applies per hit).
        """
        from repro_torch.checkpoint import manager as _ckpt
        _step, state = _ckpt.load_state(ckpt_dir, telemetry=telemetry)
        if state is None:
            return 0
        if state.get("kind") != "frontcache":
            raise ValueError(
                f"checkpoint at {ckpt_dir!r} is not a front cache "
                f"(kind={state.get('kind')!r})")
        n = 0
        for tkey, bkey, es in state["entries"]:
            e = CacheEntry.from_state(es)
            if self.target_key(e.signature) != tkey:
                raise ValueError(
                    f"front-cache snapshot entry {tkey!r}/{bkey!r} does "
                    f"not match its stored signature — refusing to load "
                    f"a corrupted cache")
            self._entries[(tkey, bkey)] = e
            self._entries.move_to_end((tkey, bkey))
            n += 1
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
        return n


class FrontResponse(NamedTuple):
    """One served front: the constrained archive plus decode context.
    ``decoded_front()`` matches ``CoexploreFront.decoded_front()`` for
    the standalone sweep of the same budget."""
    archive: ParetoArchive
    models: tuple
    space: dict | None
    metrics: tuple
    budget: Budget | None
    budget_stats: BudgetStats | None   # None for unconstrained/superset hits
    points_evaluated: int
    served_from: str                   # sweep | join | cache:repeat | ...
    queue_s: float
    e2e_s: float

    def front(self) -> CoexploreFront:
        """The response as a ``CoexploreFront`` (report/decode adapter;
        per-model aggregates are not tracked per query)."""
        return CoexploreFront(archive=self.archive, models=self.models,
                              space=self.space, metrics=self.metrics,
                              per_model_best={},
                              points_evaluated=self.points_evaluated,
                              budget=self.budget,
                              budget_stats=self.budget_stats)

    def decoded_front(self):
        """Named (model, PE, config) points, index-aligned with
        ``archive.indices``."""
        return self.front().decoded_front()


@dataclasses.dataclass
class FrontQuery:
    """One submitted budget query and its lifecycle."""
    budget: Budget | None
    deadline_s: float | None = None
    state: str = QUEUED
    response: Optional[FrontResponse] = None
    served_from: str | None = None
    chunks_folded: int = 0
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_done: float = 0.0
    # in-flight fold state (None until admitted into a walk)
    _archive: ParetoArchive | None = dataclasses.field(
        default=None, repr=False)
    _stats: BudgetStats | None = dataclasses.field(default=None, repr=False)
    _points: int = dataclasses.field(default=0, repr=False)

    @property
    def done(self) -> bool:
        return self.state == DONE


class _ChunkRecord(NamedTuple):
    """The replay-buffer row of one evaluated chunk: everything a later
    joiner needs to fold it exactly as the live queries did."""
    obj: np.ndarray            # (N, 3) joint objectives
    idx: np.ndarray            # (N,) global flat indices
    feas: BudgetColumns        # budget-readable host columns
    acc: np.ndarray            # (N,) per-lane accuracy


class _Walk:
    """One live shared chunk walk and its coalesced queries."""

    __slots__ = ("chunks", "pending", "prefix", "superset", "queries",
                 "points", "exhausted", "started")

    def __init__(self, chunks):
        self.chunks = chunks
        self.pending: Deque = deque()    # dispatched, not yet folded
        self.prefix: list[_ChunkRecord] = []
        self.superset = ParetoArchive(len(COEXPLORE_METRICS))
        self.queries: list[FrontQuery] = []
        self.points = 0
        self.exhausted = False
        self.started = False


def _front_rows(archive: ParetoArchive,
                prefix: Sequence[_ChunkRecord]):
    """Gather the budget-readable columns + accuracies of the archive's
    front rows from the replay buffer, index-aligned with
    ``archive.indices`` (what superset cache hits re-mask)."""
    idx = archive.indices
    pos = {int(i): p for p, i in enumerate(idx)}
    cols = np.empty((len(BudgetColumns._fields), len(idx)), np.float64)
    acc = np.empty(len(idx), np.float64)
    for rec in prefix:
        for j in np.flatnonzero(np.isin(rec.idx, idx)):
            p = pos[int(rec.idx[j])]
            for c, col in enumerate(rec.feas):
                cols[c, p] = col[j]
            acc[p] = rec.acc[j]
    return BudgetColumns(*cols), acc


class FrontServer:
    """Continuous-batching Pareto-front query engine over one target.

    The target — (models, space, cost-model backend, accuracy surrogate,
    walk parameters) — is fixed at construction and fingerprinted into
    ``signature`` (the cache key).  ``submit`` enqueues a query;
    ``step`` admits queued queries and advances the shared walk by one
    chunk; ``run`` drains everything; ``query`` is the synchronous
    submit+run convenience.  Single-threaded and step-driven like
    ``ServeEngine`` — concurrency means queries coalesced per step, not
    threads.
    """

    def __init__(self, models: Sequence[ModelEntry],
                 space: dict | None = None,
                 surrogate=None, accuracy=None,
                 chunk_size: int = DEFAULT_CHUNK_SIZE,
                 max_points: int | None = None, seed: int = 0,
                 mix_models: bool = True, layer_buckets=None,
                 cache: FrontCache | None = None, cache_size: int = 16,
                 max_queue: int = 64, telemetry=None):
        self.models = tuple(models)
        if not self.models:
            raise ValueError("need at least one ModelEntry on the model axis")
        self.space = space
        self.chunk_size = int(chunk_size)
        self._model = as_cost_model(surrogate)
        self._acc = accuracy_matrix(self.models, accuracy)
        self._plan = plan_joint_walk(self.models, space=space,
                                     chunk_size=chunk_size,
                                     max_points=max_points, seed=seed,
                                     mix_models=mix_models,
                                     layer_buckets=layer_buckets)
        self.signature = dict(
            kind="frontserver",
            space=space_signature(space),
            models=[m.name for m in self.models],
            # content digest of every workload's layer IR (kind/stream/
            # gating fields included): same model names re-extracted at a
            # different context/top-k can never alias a cached front
            workloads=workloads_signature(self.models),
            backend=backend_signature(self._model),
            accuracy=_digest(self._acc),
            metrics=list(COEXPLORE_METRICS),
            chunk_size=self.chunk_size, max_points=max_points,
            seed=int(seed), mix=bool(mix_models))
        self.cache = FrontCache(cache_size) if cache is None else cache
        self.max_queue = int(max_queue)
        self._queue: Deque[FrontQuery] = deque()
        self._walk: _Walk | None = None
        self._tr = as_tracer(telemetry)
        self.chunk_evals = 0       # lifetime evaluated chunks
        self.queries_served = 0    # lifetime DONE queries

    # -- client surface ----------------------------------------------------

    def submit(self, budget: Budget | None = None,
               deadline_s: float | None = None) -> FrontQuery:
        """Enqueue one budget query (REJECTED immediately if the bounded
        queue is full)."""
        q = FrontQuery(budget=budget, deadline_s=deadline_s,
                       t_submit=time.perf_counter())
        tr = self._tr
        if tr.enabled:
            tr.counter("serve.requests")
        if len(self._queue) >= self.max_queue:
            q.state = REJECTED
            if tr.enabled:
                tr.counter("serve.front.rejected")
            return q
        self._queue.append(q)
        if tr.enabled:
            tr.gauge("serve.front.queue_depth", len(self._queue))
        return q

    def step(self) -> bool:
        """One engine iteration: admit queued queries (cache first), then
        advance the shared walk by one chunk.  Returns True while work
        remains."""
        self._admit()
        if self._walk is not None:
            self._step_walk()
        return self._walk is not None or bool(self._queue)

    def run(self, max_steps: int | None = None) -> int:
        """Step until every submitted query is DONE (or ``max_steps``)."""
        steps = 0
        while max_steps is None or steps < max_steps:
            steps += 1
            if not self.step():
                break
        return steps

    def query(self, budget: Budget | None = None,
              deadline_s: float | None = None) -> FrontResponse:
        """Synchronous convenience: submit one query and drain the
        engine.  Raises on rejection (full queue)."""
        q = self.submit(budget, deadline_s=deadline_s)
        if q.state == REJECTED:
            raise RuntimeError(
                f"query queue full ({self.max_queue} pending) — drain with "
                f"run()/step() or raise max_queue")
        self.run()
        if q.state == EXPIRED:
            raise TimeoutError(
                f"query deadline ({q.deadline_s}s) passed before admission")
        return q.response

    # -- scheduler ---------------------------------------------------------

    def _query_budget(self, q: FrontQuery) -> Budget | None:
        """The budget a query actually masks with (inactive == None)."""
        return q.budget if q.budget is not None and q.budget.active else None

    def _admit(self) -> None:
        tr = self._tr
        while self._queue:
            q = self._queue.popleft()
            now = time.perf_counter()
            if q.deadline_s is not None and now - q.t_submit > q.deadline_s:
                q.state = EXPIRED
                if tr.enabled:
                    tr.counter("serve.front.expired")
                continue
            q.t_admit = now
            if tr.enabled:
                tr.observe("serve.queue_s", now - q.t_submit)
            hit = self.cache.lookup(self.signature, self._query_budget(q))
            if hit is not None:
                self._complete_from_cache(q, *hit)
                continue
            if tr.enabled:
                tr.counter("serve.front.cache_miss")
            self._attach(q)

    def _attach(self, q: FrontQuery) -> None:
        """Join a query to the shared walk (starting one if idle),
        replaying the already-evaluated prefix for mid-sweep joiners."""
        if self._walk is None:
            self._walk = _Walk(self._plan.chunks())
        walk = self._walk
        q.state = RUNNING
        q._archive = ParetoArchive(len(COEXPLORE_METRICS))
        q._stats = BudgetStats() \
            if self._query_budget(q) is not None else None
        q.served_from = "join" if walk.started else "sweep"
        if walk.prefix:
            # chunks still in walk.pending fold for this query when they
            # finish — attaching before the fold keeps chronology exact
            tr = self._tr
            if tr.enabled:
                tr.counter("serve.front.joins")
            with tr.span("front.replay", cat="serve",
                         chunks=len(walk.prefix)):
                for rec in walk.prefix:
                    self._fold_query(q, rec)
        walk.queries.append(q)

    def _step_walk(self) -> None:
        walk = self._walk
        tr = self._tr
        # keep the dispatch-ahead window full: chunk k+1 computes on
        # device while chunk k's host-side per-query folds run below
        while not walk.exhausted and len(walk.pending) < WALK_PIPELINE_DEPTH:
            nxt = next(walk.chunks, None)
            if nxt is None:
                walk.exhausted = True
                break
            _, wl, model_ids, mids, cfg, idx = nxt
            walk.started = True
            codes = host(cfg.pe_type).astype(np.int64)
            if tr.enabled:
                tr.counter("sweep.points", len(idx))
            pending = _traced_dispatch(tr, cfg, wl, self._model,
                                       self.chunk_size, model_ids=model_ids)
            walk.pending.append((pending, mids, codes, idx))
        if walk.pending:
            pending, mids, codes, idx = walk.pending.popleft()
            res = _traced_finish(tr, pending)
            self._fold_chunk(res, mids, codes, idx)
        if walk.exhausted and not walk.pending:
            self._complete_walk()

    def _fold_chunk(self, res, mids, codes, idx) -> None:
        """One evaluated chunk -> replay buffer + superset + every
        coalesced query's archive."""
        walk = self._walk
        lane_acc = self._acc[mids, codes]
        obj = _joint_objectives(res, lane_acc)
        rec = _ChunkRecord(obj=obj, idx=np.asarray(idx, np.int64),
                           feas=BudgetColumns.from_result(res),
                           acc=lane_acc)
        walk.prefix.append(rec)
        walk.points += len(rec.idx)
        self.chunk_evals += 1
        tr = self._tr
        if tr.enabled:
            tr.counter("serve.front.chunk_evals")
        with tr.span("front.fold", cat="serve", queries=len(walk.queries)):
            # the superset fold sees the FULL chunk (also validating every
            # row's finiteness once); the per-query folds then share one
            # domination adjacency so their in-chunk reductions collapse
            # to a boolean reduce each — exact, see ``chunk_dominators``
            walk.superset.update(obj, rec.idx)
            dom = chunk_dominators(obj) if walk.queries else None
            for q in walk.queries:
                self._fold_query(q, rec, dom=dom)

    def _fold_query(self, q: FrontQuery, rec: _ChunkRecord,
                    dom=None) -> None:
        """Per-query share of one chunk: feasibility mask + archive fold
        (identical arithmetic to the standalone constrained walk).  The
        join-replay path passes no ``dom`` — adjacencies are transient,
        never kept in the replay buffer."""
        q._points += len(rec.idx)
        q.chunks_folded += 1
        fold_budget_chunk(q._archive, rec.obj, rec.idx, result=rec.feas,
                          budget=self._query_budget(q), accuracy=rec.acc,
                          stats=q._stats, dom=dom)

    def _complete_walk(self) -> None:
        walk, self._walk = self._walk, None
        # cache the unconstrained superset first (with its front rows'
        # budget columns — the superset-hit feasibility check), so an
        # unconstrained query below never clobbers it with a feas-less
        # entry
        feas, acc = _front_rows(walk.superset, walk.prefix)
        self.cache.store(self.signature, None, walk.superset, walk.points,
                         feas=feas, accuracy=acc)
        for q in walk.queries:
            self._finalize(q)

    def _finalize(self, q: FrontQuery) -> None:
        budget = self._query_budget(q)
        q.state = DONE
        q.t_done = time.perf_counter()
        q.response = FrontResponse(
            archive=q._archive, models=self.models, space=self.space,
            metrics=COEXPLORE_METRICS, budget=q.budget,
            budget_stats=q._stats, points_evaluated=q._points,
            served_from=q.served_from, queue_s=q.t_admit - q.t_submit,
            e2e_s=q.t_done - q.t_submit)
        self.queries_served += 1
        tr = self._tr
        if tr.enabled:
            tr.counter("serve.front.queries")
            tr.observe("serve.request_s", q.t_done - q.t_submit)
        if budget is not None:
            # warm the per-budget entry for repeat queries
            self.cache.store(
                self.signature, budget, q._archive, q._points,
                stats=None if q._stats is None else q._stats.as_dict())

    def _complete_from_cache(self, q: FrontQuery, kind: str,
                             archive: ParetoArchive,
                             entry: CacheEntry) -> None:
        q.served_from = f"cache:{kind}"
        q.state = DONE
        q.t_done = time.perf_counter()
        stats = None
        if kind == "repeat" and entry.stats is not None:
            stats = BudgetStats.from_dict(entry.stats)
        q.response = FrontResponse(
            archive=archive, models=self.models, space=self.space,
            metrics=COEXPLORE_METRICS, budget=q.budget, budget_stats=stats,
            points_evaluated=entry.points_evaluated,
            served_from=q.served_from, queue_s=q.t_admit - q.t_submit,
            e2e_s=q.t_done - q.t_submit)
        self.queries_served += 1
        tr = self._tr
        if tr.enabled:
            tr.counter("serve.front.cache_hit")
            tr.counter("serve.front.queries")
            tr.observe("serve.request_s", q.t_done - q.t_submit)
