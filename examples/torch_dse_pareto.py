"""DSE + Pareto case study over one paper workload (Fig. 4 end to end) on
the PyTorch/CUDA port.

  PYTHONPATH=src python examples/torch_dse_pareto.py [--workload resnet50-imagenet]
  PYTHONPATH=src python examples/torch_dse_pareto.py --device cpu --max-points 2000

The counterpart of examples/dse_pareto.py, on the CUDA card by default
(``--device cpu`` for the CPU).  Writes results/dse/<workload>_torch.csv
(``--out`` elsewhere) with one row per design point (config, perf/area,
energy, Pareto membership): the paper's scatter plots as data (CRLF line
endings, as the reference's csv writer gives them).
"""

import argparse
import csv
import os

import numpy as np

from repro_torch.core import (DEFAULT_CHUNK_SIZE, PAPER_WORKLOADS,
                              enumerate_space, evaluate_space,
                              normalized_report, pareto_front,
                              report_pe_types)
from repro_torch.core.arch import config_rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="resnet20-cifar10",
                    choices=list(PAPER_WORKLOADS))
    ap.add_argument("--max-points", type=int, default=None,
                    help="subsample the space (default: full 27k paper grid)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="CSV path (default results/dse/<workload>_torch.csv)")
    args = ap.parse_args()

    space = enumerate_space(max_points=args.max_points, seed=0,
                            device=args.device)
    res = evaluate_space(space, PAPER_WORKLOADS[args.workload](
        device=args.device), chunk_size=DEFAULT_CHUNK_SIZE)
    mask = np.asarray(pareto_front(res).cpu())

    out = args.out or f"results/dse/{args.workload}_torch.csv"
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(["pe_type", "pe_rows", "pe_cols", "gbuf_kb", "spad_ifmap",
                     "spad_filter", "spad_psum", "bandwidth_gbps",
                     "perf_per_area", "energy_j", "latency_s", "area_mm2",
                     "utilization", "pareto"])
        for i, row in enumerate(config_rows(space)):
            wr.writerow([row["pe_type_name"], row["pe_rows"], row["pe_cols"],
                         row["gbuf_kb"], row["spad_ifmap"],
                         row["spad_filter"], row["spad_psum"],
                         row["bandwidth_gbps"],
                         float(res.perf_per_area[i]), float(res.energy_j[i]),
                         float(res.latency_s[i]), float(res.area_mm2[i]),
                         float(res.utilization[i]), bool(mask[i])])
    print(f"wrote {out} ({mask.sum()} Pareto points of {mask.size})")
    rep = normalized_report(res, space)
    for pe, r in report_pe_types(rep).items():
        print(f"  {pe:9s} perf/area={r['norm_perf_per_area']:.2f}x "
              f"energy={r['norm_energy']:.3f}x")


if __name__ == "__main__":
    main()
