"""Hold the DSE-at-scale runs (budgeted search, the front server) to a
reference run.

The card smoke of the port (``chip_smoke.py``, phase 9) and the script
that writes its reference from the JAX package
(``tests/_torch_scale_ref.py``) run the same searches and the same
query storm, with the settings below (those of ``benchmarks/search.py``
and ``benchmarks/frontserver.py``), and reduce them to the same plain
data:

* a search: ``Recorder`` logs, generation by generation, the archive a
  driver proposed from and a digest of what it proposed.  For a given
  archive the drivers propose exactly what the reference's propose, but
  the archive rests on float32 objectives that differ from the
  reference's by up to ~8e-6 relative, and one flipped near tie changes
  every later parent.  ``compare_search`` therefore holds the run to
  the reference generation by generation while the archives agree (the
  same proposals, objectives at ``RTOL``); where they first differ the
  difference must be a near tie (``coexplore_check.front_flips``), and
  the comparison stops there.  The halving driver proposes from its
  stage-1 screen, not from the archive: where its proposal differs on an
  equal archive, every candidate that one package kept and the other did
  not must sit at a near tie of the screen's proxy objectives with the
  cutoff (``halving_ties``, at ``PROXY_RTOL``).  A run that never
  diverged is held to the reference's final front, ``hv_ratio`` and
  ``coverage``;
* the storm: each distinct budget's front as an index set up to near
  ties, objectives at ``RTOL``, and its counts exactly up to the lanes
  that lie within ``RTOL`` of a bound.
"""

from __future__ import annotations

import hashlib

import numpy as np

from repro_torch.coexplore_check import RTOL, front_flips

# benchmarks/search.py: 3 models x MAPPED_SPACE (120 mapping codes),
# 40,000 full evaluations, seed 0; the hypervolume and coverage are
# measured against the enumerated REF_SPACE front (the paper grid x 6
# mapping codes covering every regime)
N_MODELS = 3
SEARCH_EVALS = 40_000
SEED = 0
REF_MAPPING_CODES = (0.0, 17.0, 37.0, 59.0, 83.0, 101.0)
# name -> the driver, built from a package's search module
DRIVERS = {
    "evolve": lambda m: m.EvolutionaryDriver(population=4096),
    "halving": lambda m: m.SuccessiveHalvingDriver(eta=4, rung=4096),
}

# benchmarks/frontserver.py: 8 distinct budgets (None = unconstrained)
# and the 12-query storm (the 8 plus 4 repeats of the hottest)
DISTINCT_BUDGETS = (
    None,
    dict(area_mm2=2.0),
    dict(power_mw=250.0),
    dict(area_mm2=2.0, power_mw=250.0),
    dict(area_mm2=1.5),
    dict(power_mw=400.0),
    dict(area_mm2=3.0, min_accuracy=0.5),
    dict(min_utilization=0.1),
)
STORM = tuple(range(len(DISTINCT_BUDGETS))) + (1, 2, 3, 0)
SPOT_CHECK = (1, 3)     # storm queries re-checked against standalone walks

# a screen proxy (peak MACs/s/mm^2 = clock x PEs / area, nominal pJ/MAC =
# power / (clock x PEs)) combines two or three PPA columns, each within
# RTOL of the reference's
PROXY_RTOL = 3 * RTOL


def ref_space(default_space: dict) -> dict:
    return dict(default_space, mapping=REF_MAPPING_CODES)


def hv_ref_point(ref_obj: np.ndarray) -> np.ndarray:
    """The hypervolume reference point of benchmarks/search.py: just under
    the reference front's own bounding corner."""
    lo = np.asarray(ref_obj, np.float64).min(axis=0)
    return lo - 1e-3 * np.abs(lo) - 1e-9


def quality(hypervolume, front_coverage, obj, ref_obj) -> dict:
    """``hv_ratio`` and ``coverage`` of a front against the reference
    front (the package's own ``hypervolume`` / ``front_coverage``)."""
    ref_pt = hv_ref_point(ref_obj)
    hv_ref = hypervolume(ref_obj, ref_pt)
    hv = hypervolume(np.asarray(obj, np.float64), ref_pt)
    return dict(hv_ratio=hv / hv_ref if hv_ref > 0 else 0.0,
                coverage=front_coverage(np.asarray(obj, np.float64),
                                        np.asarray(ref_obj, np.float64)))


def front_data(archive) -> dict:
    """An archive as plain data, rows ordered by index."""
    idx = np.asarray(archive.indices)
    order = np.argsort(idx, kind="stable")
    return dict(indices=idx[order].tolist(),
                objectives=np.asarray(archive.objectives,
                                      np.float64)[order].tolist())


def _digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(
        np.asarray(a, np.int64)).tobytes()).hexdigest()[:16]


class Recorder:
    """A search driver that logs, per generation, the archive it proposed
    from (``front_data``) and its proposal (count and digest; the sorted
    indices too with ``keep_proposals``); it delegates everything to
    ``driver`` (either package's).  ``proposals`` and ``screens`` keep
    each generation's proposal and stage-1 screens (candidates, result)
    in memory for ``halving_ties``."""

    def __init__(self, driver, keep_proposals: bool = False):
        self.driver = driver
        self.name = driver.name
        self.keep_proposals = keep_proposals
        self.log: list[dict] = []
        self.proposals: list[np.ndarray] = []
        self.screens: list[list] = []
        self._screened: list = []

    def reset(self, ctx) -> None:
        inner = ctx.screen

        def screen(idx):
            res = inner(idx)
            self._screened.append((np.asarray(idx, np.int64), res))
            return res
        self.driver.reset(ctx._replace(screen=screen))

    def propose(self, archive, remaining):
        self._screened = []
        out = np.asarray(self.driver.propose(archive, remaining), np.int64)
        entry = dict(archive=front_data(archive),
                     archive_order=_digest(archive.indices),
                     proposed=len(out), digest=_digest(out),
                     set_digest=_digest(np.sort(out)))
        if self.keep_proposals:
            entry["proposal"] = np.sort(out).tolist()
        self.log.append(entry)
        self.proposals.append(out)
        self.screens.append(self._screened)
        return out

    def observe(self, idx, obj, feasible) -> None:
        self.driver.observe(idx, obj, feasible)

    def state_dict(self) -> dict:
        return self.driver.state_dict()

    def restore_state(self, state: dict) -> None:
        self.driver.restore_state(state)


def _archives_close(got: dict, ref: dict, rtol: float):
    """``(equal, ties, bad)`` of two logged archives: equal index sets
    with objectives at ``rtol``, else the flips split as near ties / real
    disagreements."""
    if got["indices"] == ref["indices"]:
        a, b = np.asarray(got["objectives"]), np.asarray(ref["objectives"])
        if a.size == 0 or (np.array_equal(a[:, 0], b[:, 0]) and np.allclose(
                a[:, 1:], b[:, 1:], rtol=rtol, atol=0.0)):
            return True, [], []
        return False, [], ["objectives beyond the tolerance"]
    ties, bad = front_flips(got["indices"], got["objectives"],
                            ref["indices"], ref["objectives"], rtol)
    return False, ties, bad


def halving_ties(recorder: Recorder, g: int, ref_proposal,
                 rtol: float = PROXY_RTOL) -> tuple[list, list]:
    """Split the candidates that generation ``g`` of a halving run kept
    and the reference's did not (or the other way round) into near ties
    and real disagreements.  A candidate is at a near tie when, in some
    proxy objective, its value lies within ``rtol`` of the value at the
    run's own cutoff (the worst kept candidate's best rank): only then
    can float32 noise in the PPA columns move it across the cutoff."""
    (cand, scr), = recorder.screens[g]
    keep = np.asarray(scr.feasible, bool)
    cand, proxy = cand[keep], np.asarray(scr.proxy, np.float64)[keep]
    ranks = np.empty_like(proxy)
    for j in range(proxy.shape[1]):
        order = np.argsort(-proxy[:, j], kind="stable")
        ranks[order, j] = np.arange(len(cand))
    best = ranks.min(axis=1)
    kept = np.isin(cand, recorder.proposals[g])
    cut = int(best[kept].max())
    cut_val = np.stack([np.sort(-proxy[:, j])[cut] * -1.0
                        for j in range(proxy.shape[1])])
    ties, bad = [], []
    for i in sorted(set(recorder.proposals[g].tolist())
                    ^ set(int(x) for x in ref_proposal)):
        row = proxy[cand == i]
        near = len(row) and bool(np.any(
            np.abs(row[0] - cut_val) <= rtol * np.abs(cut_val)))
        (ties if near else bad).append(int(i))
    return ties, bad


def compare_search(got: dict, ref: dict, rtol: float = RTOL,
                   explain=None, order_matters: bool = True
                   ) -> tuple[list, list]:
    """Hold a search run (``log``, ``front``, ``hv_ratio``, ``coverage``,
    ``points_evaluated``) to the reference's.  Returns ``(problems,
    notes)``; a note says where the run left the reference at a near tie
    (and how many ties), after which nothing more is compared.

    Per generation: the archive (index set, objectives at ``rtol``), then
    the proposal as a set.  ``explain(g, ref_proposal)`` (e.g.
    ``halving_ties``) splits a differing proposal set on an equal archive
    into near ties and real disagreements; without it any such difference
    is a problem.  The same set in another order (ranks swapped at a
    near tie inside the kept set) changes only the archive's row order;
    with ``order_matters`` (a driver that picks parents by row, as the
    evolutionary one does) the comparison stops where the row orders
    part, else it goes on."""
    problems, notes = [], []
    for g, (a, b) in enumerate(zip(got["log"], ref["log"])):
        equal, ties, bad = _archives_close(a["archive"], b["archive"], rtol)
        if not equal:
            if bad:
                problems.append(f"generation {g}: archive differs beyond a "
                                f"near tie: {bad[:5]}")
            else:
                notes.append(f"generation {g}: the archive left the "
                             f"reference's at {len(ties)} near tie(s) "
                             f"{ties[:5]}; not compared further")
            return problems, notes
        if order_matters and a["archive_order"] != b["archive_order"]:
            notes.append(f"generation {g}: the archive's row order left the "
                         f"reference's; not compared further")
            return problems, notes
        if (a["proposed"], a["set_digest"]) != (b["proposed"],
                                                b["set_digest"]):
            if explain is None or "proposal" not in b:
                problems.append(f"generation {g}: the same archive, another "
                                f"proposal ({a['proposed']} vs "
                                f"{b['proposed']})")
                return problems, notes
            ties, bad = explain(g, b["proposal"])
            if bad:
                problems.append(f"generation {g}: the same archive, another "
                                f"proposal beyond a near tie: {bad[:5]} "
                                f"({len(bad)} candidates)")
            else:
                notes.append(f"generation {g}: the proposal left the "
                             f"reference's at {len(ties)} screen near "
                             f"tie(s) {ties[:5]}; not compared further")
            return problems, notes
        if a["digest"] != b["digest"]:
            notes.append(f"generation {g}: the same proposal in another "
                         f"order (a rank near tie inside the kept set)")
            if order_matters:
                return problems, notes
    if len(got["log"]) != len(ref["log"]):
        problems.append(f"{len(got['log'])} generations vs "
                        f"{len(ref['log'])}")
    if got["points_evaluated"] != ref["points_evaluated"]:
        problems.append(f"points_evaluated {got['points_evaluated']} vs "
                        f"{ref['points_evaluated']}")
    equal, ties, bad = _archives_close(got["front"], ref["front"], rtol)
    if bad:
        problems.append(f"front differs: {bad[:5]}")
    elif ties:
        notes.append(f"front: {len(ties)} near tie(s) {ties[:5]}")
    for key in ("hv_ratio", "coverage"):
        if ties:
            continue
        if not np.isclose(got[key], ref[key], rtol=rtol, atol=0.0):
            problems.append(f"{key} {got[key]!r} vs {ref[key]!r}")
    return problems, notes


def storm_data(response) -> dict:
    """One front server response as plain data: the front (row order
    kept) and its budget counts."""
    out = dict(indices=np.asarray(response.archive.indices).tolist(),
               objectives=np.asarray(response.archive.objectives,
                                     np.float64).tolist(),
               points_evaluated=int(response.points_evaluated))
    s = response.budget_stats
    if s is not None:
        out.update(evaluated=int(s.evaluated), feasible=int(s.feasible),
                   kills={k: int(v) for k, v in s.kills.items()})
    return out


def compare_storm(got: dict, ref: dict, near: dict,
                  rtol: float = RTOL) -> tuple[list, list]:
    """Hold one storm response to the reference's: the front as an index
    set up to near ties, objectives at ``rtol``, counts exactly up to
    the ``near`` lanes (per constraint) within ``rtol`` of a bound."""
    problems, notes = [], []
    g = dict(indices=sorted(got["indices"]), objectives=np.asarray(
        got["objectives"]).reshape(-1, 3)[np.argsort(got["indices"],
                                                     kind="stable")])
    r = dict(indices=sorted(ref["indices"]), objectives=np.asarray(
        ref["objectives"]).reshape(-1, 3)[np.argsort(ref["indices"],
                                                     kind="stable")])
    equal, ties, bad = _archives_close(g, r, rtol)
    problems += [f"front: {b}" for b in bad]
    notes += [f"front: joint index {t} flips at a near tie" for t in ties]
    if got["points_evaluated"] != ref["points_evaluated"]:
        problems.append(f"points_evaluated {got['points_evaluated']} vs "
                        f"{ref['points_evaluated']}")
    if "feasible" in ref or "feasible" in got:
        slack = sum(near.values())
        if abs(got.get("feasible", -1) - ref.get("feasible", -1)) > slack:
            problems.append(f"feasible {got.get('feasible')} vs "
                            f"{ref.get('feasible')} (slack {slack})")
        for name, k in ref.get("kills", {}).items():
            if abs(got.get("kills", {}).get(name, -1) - k) > near.get(name, 0):
                problems.append(f"kills {name}: "
                                f"{got.get('kills', {}).get(name)} vs {k}")
    return problems, notes
