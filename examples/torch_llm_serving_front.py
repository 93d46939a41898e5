"""LLM decode-phase co-exploration under a latency SLO, on the
PyTorch/CUDA port.

  PYTHONPATH=src python examples/torch_llm_serving_front.py
  PYTHONPATH=src python examples/torch_llm_serving_front.py \\
      --arch gemma3-1b --contexts 1024 2048 4096 --latency-ms 100
  PYTHONPATH=src python examples/torch_llm_serving_front.py --device cpu \\
      --max-points 5000

The counterpart of examples/llm_serving_front.py, on the CUDA card by
default (``--device cpu`` for the CPU): which (context length, PE type,
accelerator config) points are jointly Pareto-optimal for DECODE (one
generated token against a long KV cache) when the deployment contract
is an interactive token rate?  Decode attention streams the KV cache
with no reuse (``kind=attn_kv`` rows), so long contexts are
memory-bound and the front is set by bandwidth and quantized operand
width, not peak MACs.

The latency budget is the SLO per decode step: 100 ms/token == 10
tokens/s.  Infeasible lanes are masked inside the streaming walk (the
front is the Pareto set of the feasible subspace).  Writes
results/serving/front_torch.csv (``--out`` elsewhere) and, when pyarrow
is available, the Parquet twin beside it.
"""

import argparse
import csv
import os

import numpy as np

from repro_torch.core import (Budget, coexplore_front, coexplore_report,
                              export_front_parquet, llm_decode, model_entry)
from repro_torch.core.arch import AcceleratorConfig
from repro_torch.core.workloads import KIND_ATTN_KV


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-1b",
                    help="repro_torch.configs arch id for the decode family")
    ap.add_argument("--contexts", type=int, nargs="+",
                    default=[1024, 2048, 4096],
                    help="KV-cache lengths: one decode member per context")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--latency-ms", type=float, default=100.0,
                    help="per-decode-step latency SLO (100 ms = 10 tok/s); "
                         "0 disables the budget")
    ap.add_argument("--max-points", type=int, default=50_000,
                    help="joint-space subsample (0 = full space)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="results/serving/front_torch.csv")
    args = ap.parse_args()

    models = [model_entry(llm_decode(args.arch, context=c, batch=args.batch,
                                     device=args.device), acc_classes=True)
              for c in args.contexts]
    print(f"decode family ({args.arch}, batch={args.batch}, on "
          f"{args.device}):")
    for m in models:
        kind = np.asarray(m.workload.layers.kind.cpu())
        words = np.asarray(m.workload.layers.stream_words.cpu())
        kv_words = float(words[kind == float(KIND_ATTN_KV)].sum())
        print(f"  {m.name:32s} {m.macs / 1e6:8.1f} MMACs/step  "
              f"KV stream {kv_words / 1e6:6.2f} Mwords  "
              f"acc_mix={tuple(round(x, 3) for x in m.acc_mix)}")

    budget = None
    if args.latency_ms > 0:
        budget = Budget(latency_s=args.latency_ms * 1e-3)
        print(f"\nlatency SLO: {args.latency_ms:g} ms/step "
              f"({1e3 / args.latency_ms:.1f} tokens/s floor)")

    front = coexplore_front(models, max_points=args.max_points or None,
                            seed=args.seed, budget=budget)
    rep = coexplore_report(front)
    print(f"\nevaluated {rep['points_evaluated']:,} of "
          f"{rep['space_size']:,} joint points -> {rep['front_size']} on the "
          f"3-objective front")
    if "budget" in rep:
        b = rep["budget"]
        print(f"SLO-feasible: {b['feasible']:,}/{b['evaluated']:,} "
              f"({100 * b['feasible_fraction']:.1f}%); the rest cannot hit "
              f"{args.latency_ms:g} ms/step at these contexts")

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
    try:
        pq = os.path.splitext(args.out)[0] + ".parquet"
        export_front_parquet(pq, front.archive, front.metrics,
                             space=front.space, models=front.models)
        print(f"wrote {pq}")
    except RuntimeError as e:   # pyarrow not installed: CSV already on disk
        print(f"parquet export skipped: {e}")

    print("\nfront mix by PE type:", rep["front_counts"]["by_pe_type"])
    print("front mix by context:", rep["front_counts"]["by_model"])
    claim = rep["claim"]
    print(f"\npaper claim under the decode regime ({claim['statement']}): "
          f"{'HOLDS' if claim['holds'] else 'VIOLATED'}")
    for name, v in claim["per_model"].items():
        lp1 = v.get("lightpe1", {})
        print(f"  {name:32s} ok={v['ok']}  "
              f"lpe1 gap={lp1.get('acc_gap_vs_fp32_pp', 0.0):.2f}pp "
              f"beats_int16_bests={lp1.get('beats_int16_bests')}")


if __name__ == "__main__":
    main()
