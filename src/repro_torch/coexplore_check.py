"""Hold a joint co-exploration sweep to a reference sweep.

The card smoke of the port (``chip_smoke.py``, phase 8) and the script
that writes its reference from the JAX package
(``tests/_torch_coexplore_ref.py``) run the same walks (``RUNS``: the
13-model ``default_model_set`` times the 27,000-point paper grid under
the oracle, unconstrained and under two budgets) and reduce each front
to the same plain-data ``summary``.  ``compare`` holds one summary to
another:

* the front as an index set: a point may be on one front and not the
  other only at a near tie (``front_flips``);
* objectives of common points: accuracy exactly, the two hardware
  objectives at ``RTOL`` (XLA fuses the synthesis noise's products into
  FMAs, which moves area and clock by up to ~8e-6 relative);
* per-(model, PE) bests: accuracy exactly, the rest at ``RTOL``;
* the LightPE claim, per model, exactly;
* budget counts exactly, except that each lane whose reference area or
  power lies within ``RTOL`` of a bound (``near_bound``, counted by
  ``tests/_torch_coexplore_ref.py``) may fall on the other side.

``identical`` holds two fronts of the port to each other bit for bit
(the mixed / per-model and pruned / single-stage contracts).
"""

from __future__ import annotations

import numpy as np

RTOL = 1e-5
SUBSAMPLE = 4500

# name -> (max_points, budget bounds); every run walks DEFAULT_SPACE with
# the oracle at the default chunk size and seed, mixing models
RUNS = {
    "unconstrained": dict(max_points=None, budget=None),
    "area_0.9": dict(max_points=None, budget=dict(area_mm2=0.9)),
    "budget_4500": dict(max_points=SUBSAMPLE,
                        budget=dict(area_mm2=2.0, power_mw=250.0)),
}


def summary(front, report: dict) -> dict:
    """The JSON-able numbers of a joint sweep (``report`` is its
    ``coexplore_report``); the front is ordered by joint index."""
    order = np.argsort(np.asarray(front.archive.indices), kind="stable")
    out = dict(
        points_evaluated=int(front.points_evaluated),
        space_size=int(report["space_size"]),
        front=dict(
            indices=np.asarray(front.archive.indices)[order].tolist(),
            objectives=np.asarray(front.archive.objectives,
                                  np.float64)[order].tolist()),
        front_counts=report["front_counts"],
        layer_buckets=report["layer_buckets"],
        claim=report["claim"],
        per_model_best=[[m, pe, dict(e)] for (m, pe), e in
                        sorted(front.per_model_best.items())])
    if "budget" in report:
        out["budget"] = report["budget"]
    return out


def front_flips(idx, obj, ref_idx, ref_obj, rtol: float = RTOL):
    """Indices on one front and not the other, split into near ties
    (allowed) and real disagreements.

    A point on one front only is a near tie when the other front comes
    within ``rtol`` of dominating it in the hardware objectives (at equal
    or better accuracy) but no point of it dominates it by more than
    ``rtol``.  Accuracy is exact in both packages, so it is not perturbed.
    """
    idx, ref_idx = np.asarray(idx), np.asarray(ref_idx)
    obj, ref_obj = np.asarray(obj, np.float64), np.asarray(ref_obj, np.float64)
    ties, bad = [], []
    for i in sorted(set(idx.tolist()) ^ set(ref_idx.tolist())):
        if i in set(idx.tolist()):
            o, others = obj[idx.tolist().index(i)], ref_obj
        else:
            o, others = ref_obj[ref_idx.tolist().index(i)], obj
        tol = np.r_[0.0, rtol * np.abs(o[1:])]
        robust = np.any(np.all(others >= o + tol, axis=1))
        near = np.any(np.all(others >= o - tol, axis=1))
        (ties if near and not robust else bad).append(int(i))
    return ties, bad


def _close(a, b, rtol) -> bool:
    return bool(np.allclose(a, b, rtol=rtol, atol=0.0))


def compare(got: dict, ref: dict, rtol: float = RTOL) -> tuple[list, list]:
    """Hold a sweep's ``summary`` to the reference's.  Returns
    ``(problems, notes)``: problems are disagreements beyond the
    tolerances, notes what was tolerated."""
    problems, notes = [], []
    for key in ("points_evaluated", "space_size", "layer_buckets"):
        if got[key] != ref[key]:
            problems.append(f"{key} {got[key]!r} != {ref[key]!r}")
    idx, obj = got["front"]["indices"], np.asarray(got["front"]["objectives"])
    r_idx = ref["front"]["indices"]
    r_obj = np.asarray(ref["front"]["objectives"])
    ties, bad = front_flips(idx, obj, r_idx, r_obj, rtol)
    notes += [f"front: joint index {i} flips at a near tie" for i in ties]
    problems += [f"front: joint index {i} differs" for i in bad]
    common = sorted(set(idx) & set(r_idx))
    a = obj[[idx.index(i) for i in common]].reshape(-1, 3)
    b = r_obj[[r_idx.index(i) for i in common]].reshape(-1, 3)
    if not np.array_equal(a[:, 0], b[:, 0]):
        problems.append("front: accuracy objectives differ")
    if not _close(a[:, 1:], b[:, 1:], rtol):
        worst = np.max(np.abs(a[:, 1:] - b[:, 1:]) / np.abs(b[:, 1:]))
        problems.append(f"front: hardware objectives differ by {worst:.3g}")
    if ties:
        notes.append(f"front_counts {got['front_counts']} vs "
                     f"{ref['front_counts']} (near ties)")
    elif got["front_counts"] != ref["front_counts"]:
        problems.append(f"front_counts {got['front_counts']} != "
                        f"{ref['front_counts']}")
    best = {(m, pe): e for m, pe, e in got["per_model_best"]}
    r_best = {(m, pe): e for m, pe, e in ref["per_model_best"]}
    if set(best) != set(r_best):
        problems.append("per_model_best: different (model, PE) keys")
    for key in set(best) & set(r_best):
        e, r = best[key], r_best[key]
        if e["accuracy"] != r["accuracy"] or not _close(
                [e["macs_per_s_per_mm2"], e["energy_per_mac_pj"]],
                [r["macs_per_s_per_mm2"], r["energy_per_mac_pj"]], rtol):
            problems.append(f"per_model_best {key}: {e} vs {r}")
    problems += _claim_problems(got["claim"], ref["claim"])
    if "budget" in ref or "budget" in got:
        p, n = _budget_problems(got.get("budget"), ref.get("budget"),
                                ref.get("near_bound", {}))
        problems, notes = problems + p, notes + n
    return problems, notes


def _claim_problems(claim: dict, ref: dict) -> list:
    problems = []
    for key in ("holds", "indeterminate"):
        if claim[key] != ref[key]:
            problems.append(f"claim.{key} {claim[key]!r} != {ref[key]!r}")
    for model, r in ref["per_model"].items():
        v = claim["per_model"].get(model, {})
        if v.get("ok") != r.get("ok"):
            problems.append(f"claim {model}: ok {v.get('ok')!r} != "
                            f"{r.get('ok')!r}")
            continue
        for lp in ("lightpe1", "lightpe2"):
            if v.get(lp) != r.get(lp):
                problems.append(f"claim {model}.{lp}: {v.get(lp)} != "
                                f"{r.get(lp)}")
    return problems


def _budget_problems(got, ref, near: dict) -> tuple[list, list]:
    """Budget counts exactly, each within the number of reference lanes
    that lie within RTOL of a bound."""
    if got is None or ref is None:
        return [f"budget section {got!r} vs {ref!r}"], []
    problems, notes = [], []
    if got["spec"] != ref["spec"] or got["evaluated"] != ref["evaluated"]:
        problems.append(f"budget spec/evaluated {got['spec']}/"
                        f"{got['evaluated']} != {ref['spec']}/"
                        f"{ref['evaluated']}")
    slack = sum(near.values())
    notes.append(f"budget: {slack} reference lanes lie within the "
                 f"tolerance of a bound ({near})")
    for key in ("feasible", "pruned"):
        d = abs(got[key] - ref[key])
        if d > slack:
            problems.append(f"budget.{key} {got[key]} != {ref[key]}")
        elif d:
            notes.append(f"budget.{key} {got[key]} vs {ref[key]} "
                         f"(near the bound)")
    for name, k in ref["kills"].items():
        d = abs(got["kills"].get(name, -1) - k)
        if d > near.get(name, 0):
            problems.append(f"budget kills {name}: "
                            f"{got['kills'].get(name)} != {k}")
        elif d:
            notes.append(f"budget kills {name}: {got['kills'][name]} vs "
                         f"{k} (near the bound)")
    return problems, notes


def identical(a, b) -> list:
    """Where two fronts of the port differ bit for bit: front indices and
    objectives (ordered by index), per-(model, PE) bests, points
    evaluated and the evaluated / feasible / kill counts of the budget
    (not ``pruned``, which only a two-stage walk counts).  Empty when
    they are identical."""
    out = []
    ia, ib = np.asarray(a.archive.indices), np.asarray(b.archive.indices)
    oa, ob = np.argsort(ia, kind="stable"), np.argsort(ib, kind="stable")
    if not np.array_equal(ia[oa], ib[ob]):
        out.append(f"front indices {sorted(ia.tolist())} vs "
                   f"{sorted(ib.tolist())}")
    elif not np.array_equal(a.archive.objectives[oa],
                            b.archive.objectives[ob]):
        out.append("front objectives")
    if a.per_model_best != b.per_model_best:
        out.append("per_model_best")
    if a.points_evaluated != b.points_evaluated:
        out.append(f"points_evaluated {a.points_evaluated} vs "
                   f"{b.points_evaluated}")
    sa, sb = a.budget_stats, b.budget_stats
    key = lambda s: None if s is None else (  # noqa: E731
        s.evaluated, s.feasible, s.kills)
    if key(sa) != key(sb):
        out.append(f"budget_stats {sa} vs {sb}")
    return out
