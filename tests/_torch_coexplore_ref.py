"""The JAX package's results for the port's joint co-exploration walks.

``build_reference`` runs ``repro_torch.coexplore_check.RUNS`` with the
JAX package (the 13-model ``default_model_set`` on the 27,000-point paper
grid, oracle backend: unconstrained, under ``Budget(area_mm2=0.9)``, and
4,500 subsampled points under ``Budget(area_mm2=2.0, power_mw=250.0)``)
and returns them in the layout of ``coexplore_check.summary``, plus the
(model, PE) accuracy matrix and, per budgeted run, how many visited
lanes lie within ``coexplore_check.RTOL`` of each bound (the lanes whose
side of the bound the port may see differently).
``tests/data/torch_coexplore_ref.json`` holds the result, which
``chip_smoke.py`` holds the port to on a machine without JAX;
``tests/test_torch_coexplore.py`` rebuilds its 4,500-point run to keep
the file honest.

  PYTHONPATH=src python tests/_torch_coexplore_ref.py   # rewrite the file
"""

import json
from pathlib import Path

import numpy as np

REF_PATH = Path(__file__).resolve().parent / "data" / "torch_coexplore_ref.json"


def near_bound(models, max_points, budget, rtol) -> dict:
    """Per constraint, the visited lanes whose reference value lies within
    ``rtol`` of the bound (the per-model walk visits the same lanes)."""
    from repro.core import evaluate_chunk, iter_joint_space_chunks
    from repro.core.dse import DEFAULT_CHUNK_SIZE
    cons = budget.constraints()
    near = {c.name: 0 for c in cons}
    for m, cfg, idx in iter_joint_space_chunks(
            None, num_models=len(models), chunk_size=DEFAULT_CHUNK_SIZE,
            max_points=max_points, seed=0, group_by_model=True):
        res = evaluate_chunk(cfg, models[m].workload,
                             pad_to=DEFAULT_CHUNK_SIZE)
        for c in cons:
            v = np.asarray(getattr(res, c.column), np.float64)
            near[c.name] += int(np.sum(np.abs(v - c.bound)
                                       <= rtol * abs(c.bound)))
    return near


def build_reference(runs=None) -> dict:
    """The JAX package's summaries of ``runs`` (default: all of RUNS)."""
    from repro.core import (Budget, accuracy_matrix, coexplore_front,
                            coexplore_report, default_model_set)
    from repro_torch.coexplore_check import RTOL, RUNS, summary
    models = default_model_set()
    out = dict(models=[m.name for m in models],
               accuracy_matrix=accuracy_matrix(models).tolist(), runs={})
    for name in RUNS if runs is None else runs:
        spec = RUNS[name]
        budget = None if spec["budget"] is None else Budget(**spec["budget"])
        front = coexplore_front(models, max_points=spec["max_points"],
                                budget=budget)
        run = summary(front, coexplore_report(front))
        if budget is not None:
            run["near_bound"] = near_bound(models, spec["max_points"],
                                           budget, RTOL)
        out["runs"][name] = run
    return out


if __name__ == "__main__":
    REF_PATH.parent.mkdir(parents=True, exist_ok=True)
    REF_PATH.write_text(json.dumps(build_reference(), indent=1) + "\n")
    print(f"wrote {REF_PATH}")
