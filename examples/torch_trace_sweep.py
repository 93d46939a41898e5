"""Instrumented DSE sweep on the PyTorch/CUDA port: telemetry end to end.

  PYTHONPATH=src python examples/torch_trace_sweep.py [--shards 4] [--max-points N]
  PYTHONPATH=src python examples/torch_trace_sweep.py --device cpu

The counterpart of examples/trace_sweep.py, on the CUDA card by default
(``--device cpu`` for the CPU).  Runs a sharded streaming Pareto sweep
with a ``repro_torch.obs.Tracer`` on the ``telemetry=`` knob, then shows
every sink the tracer feeds:

  results/trace_torch/events.jsonl      — streaming event log
  results/trace_torch/trace.json        — chrome://tracing / Perfetto,
                                          one lane per shard
  results/trace_torch/sweep_report.json — phase attribution

and prints where the wall clock went (decode / dispatch / device_wait /
archive), pts/s and RSS growth.  The port compiles nothing, so its
report shows no compile events.  The front is bit-identical with the
knob off (asserted below).
"""

import argparse

import numpy as np

from repro_torch.core import PAPER_WORKLOADS, pareto_front_streaming
from repro_torch.obs import (Tracer, build_sweep_report, write_chrome_trace,
                             write_sweep_report)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workload", default="resnet20-cifar10",
                    choices=list(PAPER_WORKLOADS))
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--max-points", type=int, default=6000,
                    help="subsample the 27k paper grid (default 6000)")
    args = ap.parse_args()

    wl = PAPER_WORKLOADS[args.workload](device=args.device)
    # a CPU walk shards over the CPU; a card walk over every card
    devices = [args.device] * args.shards if args.device == "cpu" else None

    with Tracer(jsonl_path="results/trace_torch/events.jsonl") as tr:
        archive, _ = pareto_front_streaming(
            wl, max_points=args.max_points, shards=args.shards,
            devices=devices, telemetry=tr)
        report = build_sweep_report(tr)
        write_chrome_trace("results/trace_torch/trace.json", tr)
        write_sweep_report("results/trace_torch/sweep_report.json", report)

    print(report.render())
    print(f"front: {len(archive)} points; "
          f"dropped events: {tr.dropped_events}")
    print("wrote results/trace_torch/{events.jsonl,trace.json,"
          "sweep_report.json}")

    # the off-switch contract: same front without telemetry, bit for bit
    plain, _ = pareto_front_streaming(wl, max_points=args.max_points,
                                      shards=args.shards, devices=devices)
    assert np.array_equal(plain.indices, archive.indices)
    assert np.array_equal(plain.objectives, archive.objectives)
    print("front bit-identical with telemetry off: True")


if __name__ == "__main__":
    main()
