"""Budgeted search drivers: Pareto-front recovery without enumeration
(port of ``repro.core.search``).

Enumeration is affordable on the paper's 27k grid and not on the
mapping-extended ``arch.MAPPED_SPACE`` (120x).  The fixed-shape chunk
evaluator is a population evaluator, so a strategy that proposes
arbitrary config-index batches reuses it as is.

* ``SearchDriver`` — the propose/observe protocol.  A driver proposes
  batches of flat JOINT indices (model digit slowest, the
  ``arch.joint_space_points`` order); the engine scores them through
  ``dispatch_chunk`` / ``finish_chunk`` at the fixed chunk shape, masks
  by the ``Budget`` via ``fold_budget_chunk``, folds survivors into the
  streaming ``ParetoArchive`` and hands the scored batch back through
  ``observe``, until the evaluation budget or the space runs out.
* ``EvolutionaryDriver`` — batched multi-objective evolution on the
  mixed-radix digit vectors: non-dominated parents from the live
  archive, per-digit uniform crossover and mutation, dedup against a
  visited-index set, random immigrants for any shortfall.  With a budget
  of at least the space size it covers the whole space.
* ``SuccessiveHalvingDriver`` — a racer: wide cheap stage-1 screens
  through the PPA stage (the ``TwoStagePruner`` fidelity: config-stage
  bounds, proxy objectives), then full dataflow folds on the surviving
  top fraction.
* ``search_front`` — the engine; ``coexplore_front(driver=...)``
  delegates here, so drivers compose with budgets, both cost-model
  backends, sharded dispatch, ``search.*`` telemetry and checkpoint /
  resume of driver state (RNG, population, visited set).

The drivers draw from numpy generators only, so for the same archive
and observations they propose exactly what the reference's propose.
``hypervolume`` and ``front_coverage`` quantify recovery against an
enumerated reference front.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, NamedTuple, Protocol, Sequence, runtime_checkable

import numpy as np
import torch

from repro_torch.core.accuracy import AccuracySurrogate
from repro_torch.core.arch import (config_to, joint_space_size, space_points,
                                   space_radices, space_size)
from repro_torch.core.constraints import Budget, BudgetStats
from repro_torch.core.costmodel import CostModel, as_cost_model
from repro_torch.core.coexplore import (COEXPLORE_METRICS, CoexploreFront,
                                        ModelEntry, _joint_objectives,
                                        _update_per_model_best,
                                        accuracy_matrix, plan_joint_walk)
from repro_torch.core.dse import (DEFAULT_CHUNK_SIZE, ParetoArchive, _PPAView,
                                  _pad_config, _ppa_stage, _traced_dispatch,
                                  _traced_finish, dispatch_chunk,
                                  finish_chunk, fold_budget_chunk)
from repro_torch.core.ppa import PPAModels
from repro_torch.device import host
from repro_torch.obs import as_tracer

__all__ = ["SearchDriver", "EvolutionaryDriver", "SuccessiveHalvingDriver",
           "SearchContext", "ScreenResult", "search_front", "search_driver",
           "hypervolume", "front_coverage", "joint_digits", "joint_indices",
           "joint_radices"]


# ---------------------------------------------------------------------------
# Mixed-radix genome ops: flat joint index <-> digit vector.
#
# Digit order is [model_id, *AcceleratorConfig fields] — the model is the
# slowest digit, matching the joint enumeration order, and the accel
# digits follow ``space_points``'s own stride arithmetic exactly (last
# axis fastest).  ``joint_indices(joint_digits(i)) == i`` for every valid
# index, and any in-bounds digit vector decodes to a valid index — the
# round-trip the genome property tests pin down.
# ---------------------------------------------------------------------------

def joint_radices(space: dict | None, num_models: int) -> np.ndarray:
    """Digit bases of the joint genome: ``[num_models, *axis lengths]``."""
    return np.concatenate([[np.int64(num_models)], space_radices(space)])


def _strides(radices: np.ndarray) -> np.ndarray:
    return np.concatenate([np.cumprod(radices[::-1])[::-1][1:], [1]])


def joint_digits(indices: np.ndarray, radices: np.ndarray) -> np.ndarray:
    """(N, D) digit matrix of flat joint indices (model digit first)."""
    idx = np.asarray(indices, np.int64)[:, None]
    s = _strides(radices)[None, :]
    return (idx // s) % radices[None, :]


def joint_indices(digits: np.ndarray, radices: np.ndarray) -> np.ndarray:
    """Flat joint indices of an (N, D) digit matrix — the exact inverse of
    ``joint_digits``; digits must be in ``[0, radices)``."""
    d = np.asarray(digits, np.int64)
    if d.size and ((d < 0).any() or (d >= radices[None, :]).any()):
        raise ValueError("digits out of range for the given radices")
    return d @ _strides(radices)


# ---------------------------------------------------------------------------
# Driver protocol + engine-provided context.
# ---------------------------------------------------------------------------

class ScreenResult(NamedTuple):
    """One cheap stage-1 screen of a candidate batch: the batched PPA
    stage's columns plus the budget's CONFIG-stage verdict — no dataflow
    fold was paid.  ``proxy`` is a higher-is-better (N, 3) matrix
    (accuracy, peak MACs/s/mm^2, -nominal pJ/MAC) comparable across the
    batch — a fidelity rung below the full objectives, good enough to
    rank, never folded into the archive."""
    feasible: np.ndarray     # (N,) bool — config-stage budget verdict
    proxy: np.ndarray        # (N, 3) float64 higher-is-better proxy
    area_mm2: np.ndarray     # (N,) float64


class SearchContext(NamedTuple):
    """What the engine hands a driver at ``reset`` time: the joint-space
    geometry, the eval budget, and the cheap ``screen`` callable (flat
    joint indices -> ``ScreenResult``) that runs the batched PPA stage at
    the same chunk shape as the full evaluator."""
    space: dict | None
    num_models: int
    accel_size: int          # A = space_size(space)
    total_points: int        # num_models * A
    max_evals: int           # full-evaluation budget (lanes)
    seed: int
    acc_matrix: np.ndarray   # (M, n_pe_types) accuracy constants
    screen: Callable[[np.ndarray], ScreenResult]


@runtime_checkable
class SearchDriver(Protocol):
    """The propose/observe contract ``search_front`` drives.

    ``reset(ctx)`` binds the joint-space geometry; ``propose(archive,
    remaining)`` returns <= ``remaining`` NEW (never-proposed) flat joint
    indices — an empty array means the driver is done; ``observe(idx,
    obj, feasible)`` hands back the scored batch (objectives in
    ``COEXPLORE_METRICS`` order, post-evaluation feasibility mask).
    ``state_dict``/``restore_state`` round-trip the driver's complete
    search state (RNG, population, visited set) through
    ``repro_torch.checkpoint.manager`` for durable runs.
    """
    name: str

    def reset(self, ctx: SearchContext) -> None: ...
    def propose(self, archive: ParetoArchive,
                remaining: int) -> np.ndarray: ...
    def observe(self, idx: np.ndarray, obj: np.ndarray,
                feasible: np.ndarray) -> None: ...
    def state_dict(self) -> dict: ...
    def restore_state(self, state: dict) -> None: ...


class _VisitedMixin:
    """Shared visited-set bookkeeping: dedup, uniform unvisited sampling
    (rejection with an exact remainder fallback at any space size), and
    the visited half of ``state_dict``."""

    def _reset_visited(self) -> None:
        self._visited: set[int] = set()

    def _novel(self, idx: np.ndarray,
               limit: int | None = None) -> np.ndarray:
        """Subset of ``idx`` neither visited nor duplicated in-batch, at
        most ``limit`` long, original order preserved.  Only the KEPT
        indices are marked visited (the engine evaluates everything
        proposed) — candidates past ``limit`` stay unvisited, so a
        truncated batch never strands a point where it can neither be
        re-proposed nor counted against the remaining space."""
        out, seen = [], self._visited
        cap = len(idx) if limit is None else int(limit)
        for i in np.asarray(idx, np.int64):
            if len(out) >= cap:
                break
            v = int(i)
            if v not in seen:
                seen.add(v)
                out.append(v)
        return np.asarray(out, np.int64)

    def _exact_unvisited(self, rng: np.random.Generator, k: int,
                         n: int) -> np.ndarray:
        """Exactly ``min(k, unvisited)`` uniform unvisited indices at ANY
        space size (marks them visited): draw unvisited RANKS without
        replacement, then map rank -> index by iterated searchsorted
        correction against the sorted visited array — no ``arange(n)``,
        memory is O(len(visited) + k)."""
        vis = self._visited_state()
        left = n - len(vis)
        k = min(k, left)
        if k <= 0:
            return np.empty((0,), np.int64)
        ranks = np.sort(rng.choice(left, size=k, replace=False)
                        .astype(np.int64))
        # the rank-r unvisited index u is the least fixed point of
        # x = r + |visited <= x|; iterating from x = r converges to it
        # monotonically without overshoot
        idx = ranks
        while True:
            shifted = ranks + np.searchsorted(vis, idx, side="right")
            if np.array_equal(shifted, idx):
                break
            idx = shifted
        return self._novel(idx)

    def _sample_unvisited(self, rng: np.random.Generator, k: int,
                          n: int) -> np.ndarray:
        """Exactly ``min(k, unvisited)`` uniform unvisited indices (marks
        them visited).  Rejection sampling covers the sparse regime; the
        dense remainder and any rejection shortfall take the exact draw,
        so the sample never comes up short and a budgeted search never
        ends early just because the visited fraction grew."""
        left = n - len(self._visited)
        if left <= 0 or k <= 0:
            return np.empty((0,), np.int64)
        k = min(k, left)
        # dense-remainder regime (triggered on remainder size, not an
        # absolute space bound): draw exactly — guarantees full coverage
        # when the eval budget spans the space
        if left <= max(4 * k, 4096):
            return self._exact_unvisited(rng, k, n)
        # sparse regime: rejection sampling with bounded retries
        out: list[np.ndarray] = []
        got = 0
        for _ in range(64):
            cand = rng.integers(0, n, size=2 * (k - got), dtype=np.int64)
            fresh = self._novel(cand, limit=k - got)
            if len(fresh):
                out.append(fresh)
                got += len(fresh)
            if got >= k:
                break
        if got < k:  # shortfall: finish with the exact draw
            out.append(self._exact_unvisited(rng, k - got, n))
        return np.concatenate(out) if out else np.empty((0,), np.int64)

    def _visited_state(self) -> np.ndarray:
        return np.sort(np.fromiter(self._visited, np.int64,
                                   len(self._visited)))


class EvolutionaryDriver(_VisitedMixin):
    """Batched multi-objective evolutionary driver on mixed-radix genomes.

    Generation 0 is a uniform random population; afterwards parents are
    drawn from the LIVE archive's non-dominated front (the strongest
    selection pressure a streaming Pareto engine offers), children are
    built by per-digit uniform crossover of two parents followed by
    per-digit mutation (resample the digit uniformly from its axis), and
    the batch is deduplicated against everything ever proposed.  Any
    shortfall is topped up with random unvisited immigrants, which makes
    the driver exhaustive when the budget allows: with ``max_evals >=
    total_points`` it visits the entire space, so its front EQUALS the
    enumerated front (the recovery property test).

    Deterministic by construction: one ``np.random.Generator`` seeded
    from the context, consumed in a fixed order per generation; the
    archive it selects parents from is itself a deterministic fold.
    """

    name = "evolve"

    def __init__(self, population: int = 256, mutation: float = 0.15,
                 crossover: float = 0.5, immigrant_frac: float = 0.25):
        if population < 1:
            raise ValueError(f"population must be >= 1, got {population}")
        if not (0.0 < mutation <= 1.0):
            raise ValueError(f"mutation must be in (0, 1], got {mutation}")
        if not (0.0 <= crossover <= 1.0):
            raise ValueError(f"crossover must be in [0, 1], got {crossover}")
        self.population = int(population)
        self.mutation = float(mutation)
        self.crossover = float(crossover)
        self.immigrant_frac = float(immigrant_frac)
        self._generation = 0
        self._rng = None
        self._ctx = None

    def reset(self, ctx: SearchContext) -> None:
        self._ctx = ctx
        self._radices = joint_radices(ctx.space, ctx.num_models)
        self._rng = np.random.default_rng(ctx.seed)
        self._generation = 0
        self._reset_visited()

    def propose(self, archive: ParetoArchive, remaining: int) -> np.ndarray:
        ctx = self._ctx
        k = min(self.population, remaining,
                ctx.total_points - len(self._visited))
        if k <= 0:
            return np.empty((0,), np.int64)
        rng, gen = self._rng, self._generation
        self._generation += 1
        parents = archive.indices
        if gen == 0 or len(parents) == 0:
            return self._sample_unvisited(rng, k, ctx.total_points)
        want = max(1, k - int(round(k * self.immigrant_frac)))
        pd = joint_digits(parents, self._radices)
        # oversample children: dedup thins the batch, and ``limit`` keeps
        # the surplus unvisited so it stays proposable in later
        # generations (marking then truncating would strand it)
        pick = rng.integers(0, len(parents), size=(2, 2 * want))
        a, b = pd[pick[0]], pd[pick[1]]
        cross = rng.random((2 * want, len(self._radices))) < self.crossover
        child = np.where(cross, b, a)
        mut = rng.random(child.shape) < self.mutation
        resample = rng.integers(0, self._radices[None, :], size=child.shape)
        child = np.where(mut, resample, child)
        idx = self._novel(joint_indices(child, self._radices), limit=want)
        top_up = k - len(idx)
        if top_up > 0:
            extra = self._sample_unvisited(rng, top_up, ctx.total_points)
            idx = np.concatenate([idx, extra]) if len(extra) else idx
        return idx

    def observe(self, idx, obj, feasible) -> None:
        pass  # selection reads the archive; visited was marked at proposal

    def state_dict(self) -> dict:
        return dict(name=self.name, generation=int(self._generation),
                    rng=self._rng.bit_generator.state,
                    visited=self._visited_state())

    def restore_state(self, state: dict) -> None:
        if state.get("name") != self.name:
            raise ValueError(f"driver state is {state.get('name')!r}, "
                             f"not {self.name!r}")
        self._generation = int(state["generation"])
        self._rng = np.random.default_rng()
        self._rng.bit_generator.state = state["rng"]
        self._visited = set(np.asarray(state["visited"], np.int64).tolist())


class SuccessiveHalvingDriver(_VisitedMixin):
    """Successive-halving racer over fidelity rungs.

    Each round draws a wide uniform batch of unscreened candidates, runs
    the CHEAP stage-1 screen (``SearchContext.screen`` — the batched PPA
    stage plus the budget's config-stage bounds, exactly the
    ``TwoStagePruner`` fidelity), ranks the survivors on the proxy
    objectives, and proposes only the top ``1/eta`` fraction for full
    dataflow evaluation.  Ranking keeps per-objective champions first
    (best rank across the three proxy columns), so the racer preserves
    front DIVERSITY, not just a scalar winner.

    When the budget covers the whole space the racer keeps every
    config-feasible candidate — config-stage kills are exact (the same
    bounds the pruned enumerated walk applies), so its budgeted front
    again equals the enumerated front.
    """

    name = "halving"

    def __init__(self, eta: int = 4, rung: int = 4096):
        if eta < 2:
            raise ValueError(f"eta must be >= 2, got {eta}")
        if rung < 1:
            raise ValueError(f"rung must be >= 1, got {rung}")
        self.eta = int(eta)
        self.rung = int(rung)
        self._round = 0
        self._rng = None
        self._ctx = None

    def reset(self, ctx: SearchContext) -> None:
        self._ctx = ctx
        self._rng = np.random.default_rng(ctx.seed)
        self._round = 0
        self._reset_visited()

    def propose(self, archive: ParetoArchive, remaining: int) -> np.ndarray:
        ctx = self._ctx
        if remaining <= 0:
            return np.empty((0,), np.int64)
        self._round += 1
        left = ctx.total_points - len(self._visited)
        generous = ctx.max_evals >= ctx.total_points
        wide = left if generous else min(self.rung * self.eta, left)
        cand = self._sample_unvisited(self._rng, wide, ctx.total_points)
        if not len(cand):
            return cand
        scr = ctx.screen(cand)
        cand, proxy = cand[scr.feasible], scr.proxy[scr.feasible]
        if not len(cand):
            return np.empty((0,), np.int64)
        if generous:
            return cand[:remaining]
        keep = min(remaining, max(1, -(-len(cand) // self.eta)))
        # best-rank-across-objectives ordering: the k-th kept candidate
        # is within the top-k of at least one proxy objective
        ranks = np.empty_like(proxy)
        for j in range(proxy.shape[1]):
            order = np.argsort(-proxy[:, j], kind="stable")
            ranks[order, j] = np.arange(len(cand))
        best = ranks.min(axis=1)
        order = np.lexsort((cand, best))     # deterministic tie-break
        return cand[order[:keep]]

    def observe(self, idx, obj, feasible) -> None:
        pass

    def state_dict(self) -> dict:
        return dict(name=self.name, round=int(self._round),
                    rng=self._rng.bit_generator.state,
                    visited=self._visited_state())

    def restore_state(self, state: dict) -> None:
        if state.get("name") != self.name:
            raise ValueError(f"driver state is {state.get('name')!r}, "
                             f"not {self.name!r}")
        self._round = int(state["round"])
        self._rng = np.random.default_rng()
        self._rng.bit_generator.state = state["rng"]
        self._visited = set(np.asarray(state["visited"], np.int64).tolist())


_DRIVERS = {"evolve": EvolutionaryDriver, "halving": SuccessiveHalvingDriver}


def search_driver(spec) -> SearchDriver:
    """Resolve a driver spec: a ``SearchDriver`` passes through, a
    registered name (``"evolve"``/``"halving"``) constructs defaults."""
    if isinstance(spec, str):
        try:
            return _DRIVERS[spec]()
        except KeyError:
            raise ValueError(f"unknown search driver {spec!r}; "
                             f"registered: {sorted(_DRIVERS)}") from None
    if not isinstance(spec, SearchDriver):
        raise TypeError(f"driver must be a SearchDriver or name, "
                        f"got {type(spec).__name__}")
    return spec


# ---------------------------------------------------------------------------
# The engine.
# ---------------------------------------------------------------------------

def _make_screen(models, space, cost_model, acc_matrix, budget, chunk_size,
                 accel_size, telemetry, counters, device=None):
    """Build the stage-1 screen callable: flat joint indices -> PPA
    columns + config-stage feasibility + proxy objectives.  Every batch
    is padded to the fixed chunk shape and priced by the PPA stage on
    ``device`` (default: the models' device), as the full evaluator
    prices it; the screen waits for its columns."""
    tr = as_tracer(telemetry)
    config_cons = budget.config_constraints() if budget is not None else ()
    if device is None:
        device = models[0].workload.layers.H.device

    def screen(idx: np.ndarray) -> ScreenResult:
        idx = np.asarray(idx, np.int64)
        if not len(idx):
            empty = np.empty((0,), np.float64)
            return ScreenResult(np.empty((0,), bool),
                                np.empty((0, 3), np.float64), empty)
        counters["screened"] += len(idx)
        if tr.enabled:
            tr.counter("search.screened", len(idx))
        mids = idx // accel_size
        codes_all, areas, clocks, powers = [], [], [], []
        with tr.span("screen", cat="search"):
            for lo in range(0, len(idx), chunk_size):
                part = idx[lo:lo + chunk_size]
                cfg = space_points(part % accel_size, space, "cpu")
                n = len(part)
                if n < chunk_size:
                    cfg = _pad_config(cfg, chunk_size - n)
                codes_all.append(host(cfg.pe_type).astype(np.int64)[:n])
                cfg, _staged = config_to(cfg, device)
                power, clock, area, _leak = _ppa_stage(
                    cost_model.ppa_fn, cost_model.ppa_params, cfg)
                power, clock, area = host(
                    torch.stack([power, clock, area])[:, :n]
                ).astype(np.float64)
                areas.append(area)
                clocks.append(clock)
                powers.append(power)
        codes = np.concatenate(codes_all)
        area = np.concatenate(areas)
        clock = np.concatenate(clocks)
        power = np.concatenate(powers)
        lane_acc = acc_matrix[mids, codes]
        cfg_cols = space_points(idx % accel_size, space, "cpu")
        num_pes = (host(cfg_cols.pe_rows).astype(np.float64)
                   * host(cfg_cols.pe_cols).astype(np.float64))
        peak = clock * 1e9 * num_pes / np.maximum(area, 1e-9)
        e_nom = power * 1e-3 / np.maximum(clock * 1e9 * num_pes, 1.0) * 1e12
        proxy = np.stack([lane_acc, peak, -e_nom], axis=-1)
        if config_cons:
            mask, _kills = budget.feasibility(_PPAView(area_mm2=area),
                                              accuracy=lane_acc,
                                              constraints=config_cons)
        else:
            mask = np.ones(len(idx), bool)
        return ScreenResult(feasible=mask, proxy=proxy, area_mm2=area)

    return screen


def search_front(
        models: Sequence[ModelEntry],
        space: dict | None = None,
        driver: SearchDriver | str = "evolve",
        surrogate: PPAModels | CostModel | str | None = None,
        accuracy: AccuracySurrogate | None = None,
        chunk_size: int = DEFAULT_CHUNK_SIZE,
        max_evals: int = 50_000,
        seed: int = 0,
        budget: Budget | None = None,
        layer_buckets: Sequence[int] | None = None,
        shards: int | None = None,
        devices=None,
        pipeline_depth: int | None = None,
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 8,
        telemetry=None) -> CoexploreFront:
    """Drive a budgeted search over the joint (model x accelerator) space.

    The search twin of ``coexplore_front``: the ``driver`` proposes flat
    joint-index batches and the engine scores them through the walk's
    machinery: ``dispatch_chunk`` at the fixed ``chunk_size`` shape
    (bucketed by layer count), ``fold_budget_chunk`` for budget masking
    and archive folding, and the per-(model, PE) best-seen aggregates.
    ``max_evals`` caps FULL dataflow evaluations (lanes); stage-1 screens
    (``SuccessiveHalvingDriver``) are counted apart (``search.screened``).

    Determinism: proposals are partitioned into per-bucket sub-batches in
    a fixed order, dispatched round-robin over ``shards`` (each on its
    device and CUDA stream) with an oldest-first in-flight window, and
    FOLDED strictly in dispatch order, so the archive (hence parent
    selection, hence the whole run) is bit-reproducible for a fixed seed
    across shard counts.

    ``checkpoint_dir`` makes the run durable: archive, stats, counters
    and the driver's complete state are snapshotted atomically every
    ``checkpoint_every`` generations and auto-resumed (signature-checked)
    on restart.  Returns a ``CoexploreFront`` whose ``points_evaluated``
    counts full evaluations only.
    """
    models = tuple(models)
    if not models:
        raise ValueError("need at least one ModelEntry on the model axis")
    if max_evals < 1:
        raise ValueError(f"max_evals must be >= 1, got {max_evals}")
    from repro_torch.core import shard as _shard
    tr = as_tracer(telemetry)
    driver = search_driver(driver)
    cost_model = as_cost_model(surrogate)
    acc_matrix = accuracy_matrix(models, accuracy)
    walk = plan_joint_walk(models, space=space, chunk_size=chunk_size,
                           max_points=None, seed=seed, mix_models=True,
                           layer_buckets=layer_buckets)
    accel = space_size(space)
    total_points = joint_space_size(space, len(models))
    home = models[0].workload.layers.H.device
    n_shards, devs = _shard._resolve_for(shards, devices, home)
    lanes = _shard._make_shards(n_shards, devs, home)
    depth = _shard.DEFAULT_PIPELINE_DEPTH if pipeline_depth is None \
        else pipeline_depth
    counters = {"screened": 0}
    ctx = SearchContext(
        space=space, num_models=len(models), accel_size=accel,
        total_points=total_points, max_evals=int(max_evals), seed=int(seed),
        acc_matrix=acc_matrix,
        screen=_make_screen(models, space, cost_model, acc_matrix, budget,
                            chunk_size, accel, telemetry, counters))
    driver.reset(ctx)

    archive = ParetoArchive(len(COEXPLORE_METRICS))
    per_model_best: dict = {}
    stats = BudgetStats() if budget is not None else None
    evals = 0
    generation = 0

    ckpt = None
    if checkpoint_dir is not None:
        ckpt = _shard.SweepCheckpointer(
            checkpoint_dir, every=max(1, int(checkpoint_every)),
            # max_evals is not in the signature: resuming an interrupted
            # run with a larger budget is the point of durability, and
            # the driver state makes it exact
            signature=dict(
                kind="search", driver=driver.name, shards=n_shards,
                chunk_size=int(chunk_size),
                seed=int(seed), metrics=list(COEXPLORE_METRICS),
                budget=None if budget is None else budget.spec(),
                space=_shard.space_signature(space),
                models=[m.name for m in models],
                workloads=_shard.workloads_signature(models),
                backend=cost_model.name))
        loaded = ckpt.load(telemetry=telemetry)
        if loaded is not None:
            archive = ParetoArchive.from_state(loaded["archive"])
            per_model_best = {(m, pe): dict(e)
                              for m, pe, e in loaded["best"]}
            evals = int(loaded["evals"])
            generation = int(loaded["cursor"])
            counters["screened"] = int(loaded["screened"])
            if stats is not None and loaded.get("stats") is not None:
                stats = BudgetStats.from_dict(loaded["stats"])
            driver.restore_state(loaded["driver"])

    def _state() -> dict:
        st = dict(cursor=generation, archive=archive.state_dict(),
                  best=[[m, pe, dict(e)]
                        for (m, pe), e in per_model_best.items()],
                  evals=int(evals), screened=int(counters["screened"]),
                  driver=driver.state_dict())
        if stats is not None:
            st["stats"] = stats.as_dict()
        return st

    def _fold(res, idx, mids, codes):
        lane_acc = acc_matrix[mids, codes]
        obj = _joint_objectives(res, lane_acc)
        m_obj, m_idx, (m_mids, m_codes) = fold_budget_chunk(
            archive, obj, idx, result=res, budget=budget, accuracy=lane_acc,
            stats=stats, aux=(mids, codes), telemetry=tr, track="search")
        _update_per_model_best(per_model_best, models, acc_matrix,
                               m_mids, m_codes, m_obj)
        driver.observe(idx, obj, np.isin(idx, m_idx, assume_unique=True))

    traced = tr.enabled
    cap = max(1, n_shards * max(1, depth))
    while evals < max_evals:
        with tr.span("propose", cat="search", generation=generation):
            proposed = driver.propose(archive, max_evals - evals)
        proposed = np.asarray(proposed, np.int64)
        if not len(proposed):
            break
        if len(proposed) > max_evals - evals:
            proposed = proposed[:max_evals - evals]
        generation += 1
        if traced:
            tr.counter("search.generations")
            tr.counter("search.proposed", len(proposed))
        # per-bucket sub-batches (fixed bucket order) cut to the chunk
        # shape, dispatched round-robin over the shards and finished
        # OLDEST-FIRST: the fold order is a pure function of the
        # proposal order, whatever the shard count
        mids_all = proposed // accel
        inflight: deque = deque()
        c = 0

        def _finish_one():
            nonlocal evals
            pending, idx, mids, codes = inflight.popleft()
            res = _traced_finish(tr, pending, track="search") if traced \
                else finish_chunk(pending)
            evals += len(idx)
            if traced:
                tr.counter("search.evals", len(idx))
            _fold(res, idx, mids, codes)

        for group in walk.group_ids:
            sel = np.isin(mids_all, np.asarray(group, np.int64))
            if not sel.any():
                continue
            g_idx = proposed[sel]
            b = walk.bucket_of[int(mids_all[sel][0])]
            for lo in range(0, len(g_idx), chunk_size):
                idx = g_idx[lo:lo + chunk_size]
                mids = idx // accel
                cfg = space_points(idx % accel, space, "cpu")
                codes = host(cfg.pe_type).astype(np.int64)
                model_ids = walk.local[mids]
                sh = lanes[c % n_shards]
                stacked = sh.placed(walk.stacked[b])
                with sh.active():
                    pending = _traced_dispatch(
                        tr, cfg, stacked, sh.placed(cost_model), chunk_size,
                        model_ids=model_ids, track="search") if traced \
                        else dispatch_chunk(cfg, stacked,
                                            sh.placed(cost_model),
                                            pad_to=chunk_size,
                                            model_ids=model_ids)
                c += 1
                inflight.append((pending, idx, mids, codes))
                while len(inflight) >= cap:
                    _finish_one()
        while inflight:
            _finish_one()
        if ckpt is not None and ckpt.due(generation):
            with tr.span("checkpoint", cat="search", generation=generation):
                ckpt.save(generation, _state(), telemetry=telemetry)
    if ckpt is not None:
        ckpt.save(generation, _state(), telemetry=telemetry)
    return CoexploreFront(archive=archive, models=models, space=space,
                          metrics=COEXPLORE_METRICS,
                          per_model_best=per_model_best,
                          points_evaluated=evals, buckets=walk.buckets_meta,
                          budget=budget, budget_stats=stats)


# ---------------------------------------------------------------------------
# Front-quality metrics: how much of the enumerated front a budgeted
# search recovered.
# ---------------------------------------------------------------------------

def hypervolume(objectives: np.ndarray, ref: np.ndarray) -> float:
    """Exact dominated hypervolume of a higher-is-better point set above
    reference point ``ref`` (2- or 3-objective).

    3-D: sweep the first objective in descending order and integrate the
    2-D hypervolume of the accumulated (obj2, obj3) staircase over each
    slab — O(n^2 log n), fine at front sizes.  Points not strictly above
    ``ref`` in every objective contribute nothing.
    """
    obj = np.asarray(objectives, np.float64)
    ref = np.asarray(ref, np.float64)
    if obj.ndim != 2 or obj.shape[1] != len(ref):
        raise ValueError(f"expected (N, {len(ref)}) objectives, "
                         f"got {obj.shape}")
    obj = obj[(obj > ref[None, :]).all(axis=1)]
    if not len(obj):
        return 0.0
    if obj.shape[1] == 2:
        return _hv2(obj, ref)
    if obj.shape[1] != 3:
        raise ValueError("hypervolume supports 2 or 3 objectives")
    order = np.argsort(-obj[:, 0], kind="stable")
    s = obj[order]
    edges = np.concatenate([s[:, 0], [ref[0]]])
    hv = 0.0
    for i in range(len(s)):
        slab = edges[i] - edges[i + 1]
        if slab > 0.0:
            hv += slab * _hv2(s[:i + 1, 1:], ref[1:])
    return float(hv)


def _hv2(obj: np.ndarray, ref: np.ndarray) -> float:
    """2-D dominated hypervolume (higher-is-better) above ``ref``."""
    order = np.argsort(-obj[:, 0], kind="stable")
    hv, y_best = 0.0, ref[1]
    for x, y in obj[order]:
        if y > y_best:
            hv += (x - ref[0]) * (y - y_best)
            y_best = y
    return float(hv)


def front_coverage(front_obj: np.ndarray, ref_obj: np.ndarray) -> float:
    """Fraction of reference-front points that ``front_obj`` matches or
    dominates (weak coverage C(front, ref) in [0, 1]) — 1.0 means the
    searched front covers the whole enumerated reference."""
    ref = np.asarray(ref_obj, np.float64)
    got = np.asarray(front_obj, np.float64)
    if not len(ref):
        return 1.0
    if not len(got):
        return 0.0
    covered = 0
    for r in ref:
        if ((got >= r[None, :]).all(axis=1)).any():
            covered += 1
    return covered / len(ref)
