"""Deployment budgets for the DSE walks (port of
``repro.core.constraints``, a numpy copy).

* ``Budget``: a frozen dataclass of optional bounds (``area_mm2`` /
  ``power_mw`` / ``latency_s`` / ``energy_j`` upper, ``min_utilization`` /
  ``min_accuracy`` lower), validated once at construction and compiled by
  ``constraints()`` into named ``Constraint`` tuples.
* ``Budget.feasibility(result, accuracy=...)``: the per-chunk mask over
  the HOST float64 columns of an evaluated chunk, plus per-constraint
  kill counts.  The device evaluators are untouched: masking happens
  after a chunk's columns reach the host and before the archive.
* ``BudgetStats``: streaming evaluated/feasible/pruned counts and kills.

Masking chunk by chunk equals post-hoc filtering of the unconstrained
walk, bit for bit (it is row-wise and commutes with the archive's exact
reduction).  ``"config"``-stage bounds (chip area; the joint walk's
accuracy) are decidable from the PPA stage alone, so the two-stage walk
(``dse.TwoStagePruner``) kills their violators before the dataflow fold.

numpy only; ``DseResult`` is duck-typed through ``getattr``.
"""

from __future__ import annotations

from dataclasses import dataclass, field, fields as _dc_fields
from typing import NamedTuple

import numpy as np


class Constraint(NamedTuple):
    """One compiled bound: ``column`` of an evaluated chunk vs ``bound``.

    ``kind`` is ``"max"`` (feasible iff value <= bound) or ``"min"``
    (feasible iff value >= bound).  ``name`` is the human-readable form
    used as the key of kill counts (e.g. ``"area_mm2<=12"``).  ``stage``
    classifies WHEN the bound is decidable: ``"config"`` bounds read
    columns that are a pure function of the design config (and, on joint
    walks, the (model, PE-type) pair) — exactly what the evaluator's
    batched PPA stage produces — so a two-stage walk can kill their
    violators BEFORE paying for the per-layer dataflow fold.
    ``"workload"`` bounds need the full evaluation.
    """
    name: str
    column: str
    kind: str
    bound: float
    stage: str = "workload"


# Result columns decidable from the config-only PPA stage: chip area is
# the synthesized/predicted area verbatim, and the joint walk's accuracy
# objective is a (model, PE-type) gather — neither touches the dataflow
# walk.  Average power/latency/energy/utilization are workload-dependent
# (the result's power_mw is chip energy over runtime, NOT the PPA
# stage's nominal-activity power).
CONFIG_STAGE_COLUMNS = frozenset({"area_mm2", "accuracy"})

# Budget field -> (result column it reads, bound direction).  "accuracy"
# is not a DseResult column: it is the per-lane accuracy objective of the
# JOINT walk (coexplore), passed to ``feasibility`` explicitly.
_BUDGET_FIELDS: dict[str, tuple[str, str]] = {
    "area_mm2": ("area_mm2", "max"),
    "power_mw": ("power_mw", "max"),
    "latency_s": ("latency_s", "max"),
    "energy_j": ("energy_j", "max"),
    "min_utilization": ("utilization", "min"),
    "min_accuracy": ("accuracy", "min"),
}


@dataclass(frozen=True)
class Budget:
    """Declarative deployment budget over evaluated design points.

    Every field is optional; a ``None`` bound is inactive.  Upper bounds
    (``<=``): chip area (mm^2), average power (mW), per-inference latency
    (s), per-inference chip energy (J).  Lower bounds (``>=``): PE-array
    utilization (0..1) and — joint co-exploration walks only — predicted
    accuracy (0..1).

    Bounds are validated at construction (finite, non-negative; the two
    fractional lower bounds must lie in [0, 1]), so a walk can trust the
    compiled constraint list without re-checking per chunk.
    """
    area_mm2: float | None = None
    power_mw: float | None = None
    latency_s: float | None = None
    energy_j: float | None = None
    min_utilization: float | None = None
    min_accuracy: float | None = None

    def __post_init__(self):
        for f in _dc_fields(self):
            v = getattr(self, f.name)
            if v is None:
                continue
            v = float(v)
            if not np.isfinite(v) or v < 0.0:
                raise ValueError(
                    f"Budget.{f.name} must be a finite non-negative bound, "
                    f"got {v!r}")
            if f.name in ("min_utilization", "min_accuracy") and v > 1.0:
                raise ValueError(
                    f"Budget.{f.name} is a fraction in [0, 1], got {v!r}")
            object.__setattr__(self, f.name, v)

    def constraints(self) -> tuple[Constraint, ...]:
        """The active bounds compiled to ``Constraint`` tuples (stable
        field order, so kill-count keys are deterministic)."""
        out = []
        for fname, (column, kind) in _BUDGET_FIELDS.items():
            v = getattr(self, fname)
            if v is not None:
                op = "<=" if kind == "max" else ">="
                stage = ("config" if column in CONFIG_STAGE_COLUMNS
                         else "workload")
                out.append(Constraint(f"{column}{op}{v:g}", column, kind, v,
                                      stage))
        return tuple(out)

    def config_constraints(self) -> tuple[Constraint, ...]:
        """Active bounds decidable from the config-only PPA stage."""
        return tuple(c for c in self.constraints() if c.stage == "config")

    def workload_constraints(self) -> tuple[Constraint, ...]:
        """Active bounds that need the full workload evaluation."""
        return tuple(c for c in self.constraints() if c.stage == "workload")

    @property
    def active(self) -> bool:
        """Whether any bound is set (an empty Budget filters nothing)."""
        return any(getattr(self, f.name) is not None
                   for f in _dc_fields(self))

    def spec(self) -> dict:
        """The active bounds as a plain dict (for reports / JSON)."""
        return {f.name: getattr(self, f.name) for f in _dc_fields(self)
                if getattr(self, f.name) is not None}

    @staticmethod
    def _raise_needs_joint_walk():
        raise ValueError(
            "Budget.min_accuracy needs the joint co-exploration "
            "walk (coexplore_front) — a plain DSE result has no "
            "accuracy column")

    def feasibility(self, result,
                    accuracy: np.ndarray | None = None,
                    constraints: tuple[Constraint, ...] | None = None,
                    ) -> tuple[np.ndarray, dict[str, int]]:
        """Per-lane feasibility mask of one evaluated chunk + kill counts.

        ``result`` is any struct with the DseResult host columns
        (duck-typed).  ``accuracy`` is the per-lane accuracy objective of
        a joint walk; a ``min_accuracy`` bound without it is an error —
        the plain accelerator-only DSE has no accuracy axis to constrain.

        ``constraints`` restricts the check to a subset of the active
        bounds (default: all of them) — how the two-stage walk applies
        the config-stage bounds against the PPA-stage columns alone and
        the workload-stage bounds against the surviving full evaluation
        (``result`` then only needs the columns those constraints read).

        Returns ``(mask, kills)``: ``mask[i]`` is True iff lane *i*
        satisfies every checked bound; ``kills[name]`` counts the lanes
        each constraint rejects, counted INDEPENDENTLY over the lanes in
        ``result`` (a lane violating two bounds appears in both counts,
        so kills can sum past the number of infeasible lanes).  Note the
        two-stage walk calls this twice — config bounds over every raw
        lane, workload bounds over the config-feasible survivors only —
        so a pruned walk's workload-stage kill counts are smaller than a
        single-stage walk's whenever the stages' violators overlap.
        """
        cons = self.constraints() if constraints is None else constraints
        n = None
        for c in cons:  # lane count from the first column a bound reads
            v = accuracy if c.column == "accuracy" \
                else getattr(result, c.column, None)
            if v is not None:
                n = int(np.shape(np.asarray(v))[0])
                break
        if n is None:
            # no checked bound had a readable column: surface the
            # accuracy-needs-joint-walk error before poking around for a
            # lane count (a stage-1 PPA view has no latency column, and
            # an AttributeError here would bury the real problem)
            for c in cons:
                if c.column == "accuracy" and accuracy is None:
                    self._raise_needs_joint_walk()
            n = int(np.shape(np.asarray(result.latency_s))[0])
        mask = np.ones(n, bool)
        kills: dict[str, int] = {}
        for c in cons:
            if c.column == "accuracy":
                if accuracy is None:
                    self._raise_needs_joint_walk()
                vals = np.asarray(accuracy, np.float64)
            else:
                vals = np.asarray(getattr(result, c.column), np.float64)
            bad = ~np.isfinite(vals)
            if bad.any():
                # A NaN/inf lane fails every bound, so masking it would
                # silently relabel evaluator corruption as an over-budget
                # kill — the same corruption the unconstrained walk
                # reports loudly at the archive.  Stay loud here too.
                first = np.flatnonzero(bad)[:5].tolist()
                raise ValueError(
                    f"constraint {c.name!r} reads non-finite values in "
                    f"{int(bad.sum())} lane(s) (first: {first}) — refusing "
                    f"to count evaluator corruption as budget kills")
            ok = vals <= c.bound if c.kind == "max" else vals >= c.bound
            kills[c.name] = int(n - np.count_nonzero(ok))
            mask &= ok
        return mask, kills


@dataclass
class BudgetStats:
    """Streaming accumulator of a constrained walk's feasibility telemetry.

    ``evaluated`` counts every lane the walk evaluated (pre-mask — the
    subsample accounting, so feasible_fraction is relative to the points
    actually visited, not the full space), ``feasible`` the lanes that
    survived every bound, ``kills`` the per-constraint rejection counts
    (independent counts; see ``Budget.feasibility``).

    ``pruned`` counts the lanes a TWO-STAGE walk killed at the
    config-only PPA stage — lanes whose per-layer dataflow fold was never
    paid for.  Single-stage walks leave it 0.  Note two-stage kill
    accounting: config-stage kills are counted over every evaluated lane
    (identical to post-hoc filtering), while workload-stage kills are
    counted over the config-feasible survivors only — a lane pruned at
    stage 1 never gets workload columns to count against.
    """
    evaluated: int = 0
    feasible: int = 0
    pruned: int = 0
    kills: dict[str, int] = field(default_factory=dict)

    def record(self, mask: np.ndarray, kills: dict[str, int]) -> None:
        """Fold one chunk's (single-stage) feasibility outcome."""
        self.record_evaluated(int(len(mask)), kills)
        self.record_feasible(int(np.count_nonzero(mask)))

    def record_evaluated(self, n: int, kills: dict[str, int]) -> None:
        """Count ``n`` visited lanes plus one stage's kill counts (the
        stage-1 half of two-stage accounting)."""
        self.evaluated += int(n)
        self.merge_kills(kills)

    def record_feasible(self, n: int) -> None:
        """Count ``n`` lanes that survived every checked bound."""
        self.feasible += int(n)

    def record_pruned(self, n: int) -> None:
        """Count ``n`` lanes killed before the dataflow stage."""
        self.pruned += int(n)

    def merge_kills(self, kills: dict[str, int]) -> None:
        """Accumulate per-constraint kill counts (no lane accounting)."""
        for name, n in kills.items():
            self.kills[name] = self.kills.get(name, 0) + int(n)

    def merge(self, other: "BudgetStats") -> None:
        """Fold another accumulator into this one (sharded walks sum
        their per-shard stats; every field is an additive count, so the
        merge is associative and order-free)."""
        self.evaluated += other.evaluated
        self.feasible += other.feasible
        self.pruned += other.pruned
        self.merge_kills(other.kills)

    @classmethod
    def from_dict(cls, d: dict) -> "BudgetStats":
        """Rebuild from ``as_dict()`` output (checkpoint restore).  Extra
        keys — e.g. the derived ``feasible_fraction`` — are ignored."""
        return cls(evaluated=int(d.get("evaluated", 0)),
                   feasible=int(d.get("feasible", 0)),
                   pruned=int(d.get("pruned", 0)),
                   kills={k: int(v)
                          for k, v in dict(d.get("kills", {})).items()})

    @property
    def feasible_fraction(self) -> float:
        """Feasible share of evaluated points (0.0 before any chunk)."""
        return self.feasible / self.evaluated if self.evaluated else 0.0

    def as_dict(self) -> dict:
        """JSON-friendly summary (what coexplore_report embeds)."""
        return dict(evaluated=self.evaluated, feasible=self.feasible,
                    feasible_fraction=self.feasible_fraction,
                    pruned=self.pruned, kills=dict(self.kills))


class BudgetColumns(NamedTuple):
    """The workload-stage result columns a ``Budget`` bound can read
    (``accuracy`` is passed to ``feasibility`` separately, as always).

    A compact host float64 view of an evaluated chunk that duck-types
    into ``Budget.feasibility`` exactly like the full ``DseResult`` it
    was taken from — what a replay buffer or a warm front cache keeps
    per lane so LATER budget queries can be re-masked without paying the
    chunk evaluation again (the frontserver's mid-sweep joins and
    superset cache hits).  Column set = every ``_BUDGET_FIELDS`` target
    except ``accuracy``; masking against this view is bit-identical to
    masking against the original result because ``feasibility`` reads
    these columns (as float64) and nothing else.
    """
    area_mm2: np.ndarray
    power_mw: np.ndarray
    latency_s: np.ndarray
    energy_j: np.ndarray
    utilization: np.ndarray

    @classmethod
    def from_result(cls, result) -> "BudgetColumns":
        """Snapshot the budget-readable columns of an evaluated chunk."""
        return cls(*[np.asarray(getattr(result, f), np.float64)
                     for f in cls._fields])

    def take(self, rows) -> "BudgetColumns":
        """Row-gather every column (subset / reorder lanes)."""
        rows = np.asarray(rows)
        return BudgetColumns(*[col[rows] for col in self])

    def state_dict(self) -> dict:
        """Plain-dict form (cache entries / checkpoints)."""
        return {f: col.copy() for f, col in zip(self._fields, self)}

    @classmethod
    def from_state(cls, state: dict) -> "BudgetColumns":
        return cls(*[np.asarray(state[f], np.float64)
                     for f in cls._fields])


def mask_result(result, mask: np.ndarray):
    """Row-filter every column of a DseResult-like struct (host numpy)."""
    return type(result)(*[np.asarray(col)[mask] for col in result])


def apply_budget(result, indices: np.ndarray, budget: Budget,
                 accuracy: np.ndarray | None = None,
                 stats: BudgetStats | None = None):
    """Drop a chunk's infeasible lanes before it reaches the archive.

    Returns the filtered ``(result, indices)`` pair; records the chunk
    into ``stats`` when given.  The all-feasible fast path returns the
    inputs untouched (no copy).
    """
    mask, kills = budget.feasibility(result, accuracy)
    if stats is not None:
        stats.record(mask, kills)
    idx = np.asarray(indices)
    if mask.all():
        return result, idx
    return mask_result(result, mask), idx[mask]
