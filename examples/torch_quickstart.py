"""Quickstart on the PyTorch/CUDA port: the QADAM loop in six steps.

  PYTHONPATH=src python examples/torch_quickstart.py [--device cuda]
      [--max-points 2000]

The counterpart of examples/quickstart.py, on the CUDA card by default:
1. enumerate the accelerator design space,
2. synthesize it with the oracle and fit the polynomial PPA surrogates,
3. run the DSE on VGG-16/CIFAR-10,
4. extract the Pareto front and the paper's normalized report,
5. pick the best LightPE-1 design point,
6. apply the numerics it implies to VGG-16's weight shapes (the fused
   fake_quant kernel on the card).
"""

import argparse

import numpy as np

from repro_torch import quickstart
from repro_torch.core.dse import report_pe_types, spread
from repro_torch.kernels.fake_quant import fake_quant


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-points", type=int, default=2000,
                    help="subsample the 27k paper grid (0 = all of it)")
    args = ap.parse_args()

    res = quickstart.run(max_points=args.max_points or None,
                         device=args.device)
    print(f"PPA surrogate fit: area R2={res.r2['area_mm2']:.4f} "
          f"power R2={res.r2['power_mw']:.4f} "
          f"clock R2={res.r2['clock_ghz']:.4f}")
    print("design-space spread:", spread(res.oracle))
    print(f"Pareto front: {res.front.sum()} / {res.front.size} design points")
    for pe, r in report_pe_types(res.report).items():
        print(f"  {pe:9s} perf/area={r['norm_perf_per_area']:.2f}x "
              f"energy={r['norm_energy']:.3f}x (vs best INT16)")
    print("Pareto-optimal LightPE-1 config:", {k: res.best_config[k] for k in
          ("pe_rows", "pe_cols", "gbuf_kb", "spad_filter", "bandwidth_gbps")})
    wq = res.quantized["lightpe1"][0]
    print(f"LightPE-1 weights are powers of two ({len(res.weights)} VGG-16 "
          f"layers, {fake_quant.launches} fake_quant kernel launches):\n",
          np.asarray(wq[:2, :6].cpu()))


if __name__ == "__main__":
    main()
