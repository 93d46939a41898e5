"""The JAX package's results for the port's DSE-at-scale runs.

``build_reference`` runs, with the JAX package on this tree (the
settings of ``repro_torch.scale_check``, those of ``benchmarks/search.py``
and ``benchmarks/frontserver.py``):

* the enumerated ``REF_SPACE`` front (the first 3 models of
  ``default_model_set`` x the paper grid x 6 mapping codes);
* ``search_front`` with the evolutionary and the successive-halving
  driver at 40,000 evaluations, seed 0, over the first 3 models x
  ``MAPPED_SPACE`` (9,720,000 joint points), each driver wrapped in a
  ``scale_check.Recorder`` (its per-generation archives and proposal
  digests; the halving driver's proposals in full, which
  ``scale_check.halving_ties`` reads),
  with the front, ``hv_ratio`` and ``coverage`` against the REF_SPACE
  front;
* the reference's own ``FrontServer`` answering the 12-query storm over
  the 351,000-point joint space in one walk: the 8 distinct fronts, their
  counts, and per budget how many visited lanes lie within
  ``coexplore_check.RTOL`` of each bound.

``tests/data/torch_scale_ref.json`` holds the result, which
``chip_smoke.py`` (phase 9) holds the port to on a machine without JAX;
``tests/test_torch_search.py`` checks the file's layout and rebuilds
nothing (a full build takes minutes on the CPU).

  PYTHONPATH=src:tests python tests/_torch_scale_ref.py   # rewrite the file
"""

import json
from pathlib import Path

import numpy as np

REF_PATH = Path(__file__).resolve().parent / "data" / "torch_scale_ref.json"


def near_bounds(models, budgets, rtol) -> list:
    """Per budget, per constraint, the visited lanes whose reference value
    lies within ``rtol`` of the bound, over the unsubsampled joint walk
    (one evaluation of every chunk serves all budgets)."""
    from repro.core import evaluate_chunk, iter_joint_space_chunks
    from repro.core.dse import DEFAULT_CHUNK_SIZE
    near = [{c.name: 0 for c in b.constraints()} if b is not None else {}
            for b in budgets]
    for m, cfg, idx in iter_joint_space_chunks(
            None, num_models=len(models), chunk_size=DEFAULT_CHUNK_SIZE,
            group_by_model=True):
        res = evaluate_chunk(cfg, models[m].workload,
                             pad_to=DEFAULT_CHUNK_SIZE)
        for b, out in zip(budgets, near):
            if b is None:
                continue
            for c in b.constraints():
                if c.column == "accuracy":   # exact in both packages
                    continue
                v = np.asarray(getattr(res, c.column), np.float64)
                out[c.name] += int(np.sum(np.abs(v - c.bound)
                                          <= rtol * abs(c.bound)))
    return near


def build_reference() -> dict:
    import repro.core.search as J
    from repro.core import (Budget, coexplore_front, default_model_set,
                            front_coverage, hypervolume, search_front)
    from repro.core.arch import DEFAULT_SPACE, MAPPED_SPACE
    from repro.serve import FrontServer
    from repro_torch import scale_check as S
    from repro_torch.coexplore_check import RTOL

    models = default_model_set()
    three = models[:S.N_MODELS]
    ref = coexplore_front(three, space=S.ref_space(DEFAULT_SPACE),
                          seed=S.SEED)
    out = dict(models=[m.name for m in models],
               ref_space=dict(points_evaluated=int(ref.points_evaluated),
                              front=S.front_data(ref.archive)),
               search={}, storm={})
    ref_obj = ref.archive.objectives
    for name, make in S.DRIVERS.items():
        rec = S.Recorder(make(J), keep_proposals=name == "halving")
        front = search_front(three, space=MAPPED_SPACE, driver=rec,
                             max_evals=S.SEARCH_EVALS, seed=S.SEED)
        out["search"][name] = dict(
            points_evaluated=int(front.points_evaluated),
            front=S.front_data(front.archive), log=rec.log,
            **S.quality(hypervolume, front_coverage,
                        front.archive.objectives, ref_obj))
    budgets = [None if b is None else Budget(**b)
               for b in S.DISTINCT_BUDGETS]
    srv = FrontServer(models)
    qs = [srv.submit(budgets[i]) for i in S.STORM]
    srv.run()
    near = near_bounds(models, budgets, RTOL)
    out["storm"] = dict(
        chunk_evals=int(srv.chunk_evals),
        responses=[dict(budget=S.DISTINCT_BUDGETS[i],
                        near_bound=near[i], **S.storm_data(qs[i].response))
                   for i in range(len(S.DISTINCT_BUDGETS))])
    return out


if __name__ == "__main__":
    REF_PATH.parent.mkdir(parents=True, exist_ok=True)
    REF_PATH.write_text(json.dumps(build_reference()) + "\n")
    print(f"wrote {REF_PATH}")
