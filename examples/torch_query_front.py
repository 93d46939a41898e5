"""Pareto-front-as-a-service on the PyTorch/CUDA port: the coalesced
query engine.

  PYTHONPATH=src python examples/torch_query_front.py [--max-points 20000]
  PYTHONPATH=src python examples/torch_query_front.py --device cpu

The counterpart of examples/query_front.py, on the CUDA card by default
(``--device cpu`` for the CPU).  ``repro_torch.serve.FrontServer``
answers several teams' budget queries against one (model set, backend,
space) target from ONE shared chunk walk: concurrent queries coalesce
(per-query cost is a host feasibility mask and an archive fold), late
arrivals join the live sweep with the evaluated prefix replayed, and
completed fronts land in a warm LRU cache, so repeats, and any budget
every cached superset-front row satisfies, answer with zero chunk
evaluations.  Every response is bit-identical (indices, objectives, row
order) to a standalone ``coexplore_front(budget=...)`` sweep.
"""

import argparse
import time

from repro_torch.core import Budget, default_model_set
from repro_torch.obs import Tracer
from repro_torch.serve import FrontServer

QUERIES = {
    "hardware team (area cap)": Budget(area_mm2=2.0),
    "power team (thermal envelope)": Budget(power_mw=250.0),
    "product (accuracy floor + area)": Budget(area_mm2=3.0,
                                              min_accuracy=0.5),
    "research (unconstrained)": None,
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-points", type=int, default=20_000,
                    help="joint-space subsample (0 = full space)")
    args = ap.parse_args()

    tr = Tracer(record_events=False)
    srv = FrontServer(default_model_set(device=args.device),
                      max_points=args.max_points or None, telemetry=tr)

    # submit everything up front: the four queries coalesce onto one walk
    queries = {who: srv.submit(b) for who, b in QUERIES.items()}
    t0 = time.perf_counter()
    srv.run()
    dt = time.perf_counter() - t0

    print(f"served {len(queries)} overlapping budget queries from "
          f"{srv.chunk_evals} chunk evaluations in {dt:.2f}s "
          f"({srv.chunk_evals / len(queries):.2f} chunk evals/query)\n")
    for who, q in queries.items():
        r = q.response
        stats = (f"{r.budget_stats.feasible:,}/{r.budget_stats.evaluated:,} "
                 f"feasible" if r.budget_stats else "unconstrained")
        print(f"  {who:36s} front={len(r.archive):4d}  {stats}  "
              f"served_from={r.served_from}")

    # a repeat answers from the warm front cache, zero chunk evaluations
    t0 = time.perf_counter()
    again = srv.query(Budget(area_mm2=2.0))
    print(f"\nrepeat query: served_from={again.served_from} in "
          f"{(time.perf_counter() - t0) * 1e3:.1f}ms "
          f"(front={len(again.archive)})")

    # so does any budget every superset-front row satisfies
    loose = srv.query(Budget(power_mw=2000.0))
    print(f"loose budget:  served_from={loose.served_from} "
          f"(front={len(loose.archive)})")

    pt, obj = again.decoded_front()[0], again.archive.objectives[0]
    print(f"\nsample front point: model={pt.model} pe={pt.pe_type} "
          f"acc={obj[0]:.3f}")
    reg = tr.registry
    print(f"telemetry: p50 request "
          f"{reg.histograms['serve.request_s'].quantile(0.5) * 1e3:.1f}ms, "
          f"cache hits={srv.cache.hits}")


if __name__ == "__main__":
    main()
