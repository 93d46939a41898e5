"""Joint accelerator x model co-exploration on the PyTorch/CUDA port.

  PYTHONPATH=src python examples/torch_coexplore_pareto.py [--max-points 50000]
  PYTHONPATH=src python examples/torch_coexplore_pareto.py \\
      --area-mm2 2.0 --power-mw 250 --min-accuracy 0.40
  PYTHONPATH=src python examples/torch_coexplore_pareto.py \\
      --qat-results results/qat_pareto.json

The counterpart of examples/coexplore_pareto.py, on the CUDA card by
default (``--device cpu`` for the CPU): which (model, PE type,
accelerator config) points are jointly Pareto-optimal in accuracy x
MACs/s/mm^2 x energy per MAC, over the 13-model ``default_model_set`` x
the 27,000-point paper grid (``--max-points 0``: all 351,000 joint
points), optionally under a deployment budget (the front of the
feasible subspace) and with the accuracy surrogate calibrated from
measured QAT results.  Writes results/coexplore/front_torch.csv (one row
per front point; ``--out`` elsewhere) and checks the paper's claim.
"""

import argparse
import csv
import os

from repro_torch.core import (AccuracySurrogate, Budget, coexplore_front,
                              coexplore_report, default_model_set)
from repro_torch.core.arch import AcceleratorConfig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-points", type=int, default=50_000,
                    help="joint-space subsample (0 = full space)")
    ap.add_argument("--qat-results", default=None,
                    help="calibrate the accuracy surrogate from a "
                         "results/qat_pareto.json written by train_qat.py")
    ap.add_argument("--qat-model", default="resnet20-cifar10",
                    help="model the QAT results were measured on")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="results/coexplore/front_torch.csv")
    budget_args = ap.add_argument_group(
        "deployment budget (any subset; omit all for an unconstrained sweep)")
    budget_args.add_argument("--area-mm2", type=float, default=None,
                             help="max chip area (mm^2)")
    budget_args.add_argument("--power-mw", type=float, default=None,
                             help="max average power (mW)")
    budget_args.add_argument("--latency-ms", type=float, default=None,
                             help="max per-inference latency (ms)")
    budget_args.add_argument("--min-accuracy", type=float, default=None,
                             help="min predicted accuracy (fraction)")
    args = ap.parse_args()

    budget = None
    if any(v is not None for v in (args.area_mm2, args.power_mw,
                                   args.latency_ms, args.min_accuracy)):
        budget = Budget(
            area_mm2=args.area_mm2, power_mw=args.power_mw,
            latency_s=(None if args.latency_ms is None
                       else args.latency_ms * 1e-3),
            min_accuracy=args.min_accuracy)
        print(f"deployment budget: {budget.spec()}")

    accuracy = AccuracySurrogate()
    if args.qat_results:
        n = accuracy.load_qat_results(args.qat_results,
                                      model_name=args.qat_model)
        print(f"calibrated {n} (model, pe) accuracy points from "
              f"{args.qat_results}")

    models = default_model_set(device=args.device)
    print(f"model axis ({len(models)} models, on {args.device}):")
    for m in models:
        print(f"  {m.name:46s} {m.macs / 1e6:10.1f} MMACs  "
              f"fp32_acc={m.base_acc:.3f}")

    front = coexplore_front(models, accuracy=accuracy,
                            max_points=args.max_points or None,
                            seed=args.seed, budget=budget)
    rep = coexplore_report(front)
    print(f"\nevaluated {rep['points_evaluated']:,} of "
          f"{rep['space_size']:,} joint points -> {rep['front_size']} on "
          f"the 3-objective front (accuracy, MACs/s/mm^2, -pJ/MAC)")
    if "budget" in rep:
        b = rep["budget"]
        print(f"budget: {b['feasible']:,}/{b['evaluated']:,} points "
              f"feasible ({100 * b['feasible_fraction']:.1f}%), "
              f"{b['pruned']:,} pruned before the dataflow fold; kills:")
        for name, n in b["kills"].items():
            print(f"  {name:24s} killed {n:,}")
    for b in rep["layer_buckets"]:
        print(f"  depth-{b['depth']} bucket: {', '.join(b['models'])}")

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["model", "pe_type", "accuracy", "macs_per_s_per_mm2",
                     "energy_per_mac_pj", *AcceleratorConfig._fields])
        for p in sorted(rep["points"], key=lambda p: -p["accuracy"]):
            wr.writerow([p["model"], p["pe_type"], f"{p['accuracy']:.4f}",
                         f"{p['macs_per_s_per_mm2']:.4e}",
                         f"{p['energy_per_mac_pj']:.4f}",
                         *[p["config"][k] for k in AcceleratorConfig._fields]])
    print(f"wrote {args.out}")

    print("\nfront mix by PE type:", rep["front_counts"]["by_pe_type"])
    print("front mix by model:  ", rep["front_counts"]["by_model"])
    claim = rep["claim"]
    print(f"\npaper claim — {claim['statement']}: "
          f"{'HOLDS' if claim['holds'] else 'VIOLATED'}")
    for name, v in claim["per_model"].items():
        lp1 = v.get("lightpe1", {})
        print(f"  {name:46s} ok={v['ok']}  "
              f"lpe1 gap={lp1.get('acc_gap_vs_fp32_pp', 0.0):.2f}pp "
              f"beats_int16_bests={lp1.get('beats_int16_bests')}")


if __name__ == "__main__":
    main()
