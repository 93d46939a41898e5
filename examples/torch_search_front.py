"""Budgeted evolutionary Pareto-front search on the PyTorch/CUDA port.

  PYTHONPATH=src python examples/torch_search_front.py [--evals 40000]
  PYTHONPATH=src python examples/torch_search_front.py \\
      --driver halving --area-mm2 2.0 --power-mw 250
  PYTHONPATH=src python examples/torch_search_front.py --device cpu --evals 4000

The counterpart of examples/search_front.py, on the CUDA card by default
(``--device cpu`` for the CPU).  The mapping-extended space
(``MAPPED_SPACE``, 120x the paper grid: 9,720,000 joint points over the
first 3 models of the default axis) is past enumeration: an evolutionary
driver proposes population-sized config batches, the engine scores them
through the chunk evaluator every enumerated walk uses, and the
streaming archive supplies the next generation's parents.
``--driver halving`` races a wide cheap PPA screen instead.  Writes
results/search/front_torch.csv (one row per front point).
"""

import argparse
import os

from repro_torch.core import (Budget, default_model_set, export_front_csv,
                              joint_space_size, search_front)
from repro_torch.core.arch import MAPPED_SPACE


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--evals", type=int, default=40_000,
                    help="full-evaluation budget (lanes through the chunk "
                         "evaluator); the mapped joint space has ~9.7M "
                         "points")
    ap.add_argument("--driver", choices=("evolve", "halving"),
                    default="evolve")
    ap.add_argument("--models", type=int, default=3,
                    help="how many models of the default axis to search over")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None,
                    help="snapshot driver+archive state here (rerun = "
                         "resume; a larger --evals continues the search)")
    budget_args = ap.add_argument_group(
        "deployment budget (any subset; omit all for an unconstrained "
        "search)")
    budget_args.add_argument("--area-mm2", type=float, default=None)
    budget_args.add_argument("--power-mw", type=float, default=None)
    budget_args.add_argument("--min-accuracy", type=float, default=None)
    args = ap.parse_args()

    budget = None
    if any(v is not None for v in (args.area_mm2, args.power_mw,
                                   args.min_accuracy)):
        budget = Budget(area_mm2=args.area_mm2, power_mw=args.power_mw,
                        min_accuracy=args.min_accuracy)
        print(f"deployment budget: {budget.spec()}")

    models = default_model_set(device=args.device)[:args.models]
    total = joint_space_size(MAPPED_SPACE, len(models))
    print(f"mapped joint space: {total:,} points "
          f"({len(models)} models x {total // len(models):,} configs); "
          f"searching with {args.evals:,} evaluations "
          f"({args.evals / total:.2%} of enumeration)")

    front = search_front(models, space=MAPPED_SPACE, driver=args.driver,
                         max_evals=args.evals, seed=args.seed, budget=budget,
                         checkpoint_dir=args.checkpoint_dir)

    print(f"evaluated {front.points_evaluated:,} points -> "
          f"{len(front.archive)} non-dominated")
    if front.budget_stats is not None:
        s = front.budget_stats
        print(f"feasible: {s.feasible:,}/{s.evaluated:,} "
              f"({s.feasible_fraction:.1%}); kills: {s.kills}")

    print("\ntop of the searched front (by accuracy):")
    rows = sorted(zip(front.decoded_front(),
                      front.archive.objectives.tolist()),
                  key=lambda r: -r[1][0])
    for p, (acc, mps_mm2, neg_pj) in rows[:8]:
        print(f"  {p.model:<28} {p.pe_type:<8} "
              f"mapping={p.config['mapping']:g} acc={acc:.3f} "
              f"macs/s/mm2={mps_mm2:.3e} pJ/MAC={-neg_pj:.2f}")

    os.makedirs("results/search", exist_ok=True)
    export_front_csv("results/search/front_torch.csv", front.archive,
                     front.metrics, MAPPED_SPACE, models)
    print("\nwrote results/search/front_torch.csv")


if __name__ == "__main__":
    main()
