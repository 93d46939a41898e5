"""Counts of dry-run cells on ``meta`` as rank 0 of pod16x16
(``launch.dryrun``), with the cache's own argument bytes a device beside
each cell's counts.  Two sets (``--cells``):

  * ``seqshard``: the serving cells whose KV cache the reference splits
    over its sequence (every decoder whose KV heads do not divide
    ``model``), and the perf variant ``v1b_f8_cache_seqshard`` of
    Qwen3-32B ``decode_32k``;
  * ``ssm``: every cell of RWKV6-1.6B and Zamba2-7B (the tensor-parallel
    split of the SSM and hybrid families).

No card:

  PYTHONPATH=src python scripts/torch_seqshard_counts.py --out <json> \\
      [--cells seqshard|ssm] [--src <another checkout>/src]

``--src`` counts another tree's port (a parent commit, for a before /
after table in one run).  Writes one JSON object a cell.
"""

import argparse
import json
import sys
import time

CELLS = {
    "seqshard": [(arch, shape, None) for arch in (
        "smollm-135m", "gemma3-1b", "gemma2-9b", "qwen3-32b", "qwen2-vl-72b",
        "phi3.5-moe-42b-a6.6b") for shape in ("decode_32k", "prefill_32k")]
    + [("qwen3-32b", "decode_32k", "v1b_f8_cache_seqshard")],
    "ssm": [(arch, shape, None) for arch in ("rwkv6-1.6b", "zamba2-7b")
            for shape in ("train_4k", "prefill_32k", "decode_32k",
                          "long_500k")],
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--cells", default="seqshard", choices=list(CELLS))
    ap.add_argument("--src", default=None)
    args = ap.parse_args(argv)
    if args.src:
        sys.path.insert(0, args.src)
    import torch.distributed as dist
    from repro_torch.configs import get
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import op_analysis as OA
    from repro_torch.launch import perf as P
    from repro_torch.launch import shapes as SH

    out = []
    mesh = D.start_mesh(*D.MESHES["pod16x16"])
    for arch, shape, variant in CELLS[args.cells]:
        t0 = time.time()
        cfg = get(arch)
        if not SH.shape_runs(cfg, SH.SHAPES[shape]):
            continue
        if variant:
            _, over, opts = next(v for v in P.CELLS[(arch, shape)]
                                 if v[0] == variant)
            _, step, cell_args = P.build_variant(arch, shape, mesh, over,
                                                 opts)
            notes = []
        else:
            step, cell_args, notes = D.build_cell(arch, shape, mesh)
        cache_bytes = OA.storage_bytes(cell_args[-1])
        r = D.analyze_cell(step, cell_args)
        row = dict(arch=arch, shape=shape, variant=variant,
                   cache_bytes=cache_bytes, flops=r["flops"],
                   argument_bytes=r["memory"]["argument_size_in_bytes"],
                   temp_bytes=r["memory"]["temp_size_in_bytes"],
                   fits_80gb=r["fits_80gb"], collectives=r["collectives"],
                   launches=r["launches"],
                   note_serve=D.NOTE_SERVE in notes,
                   note_tp=D.NOTE_TP in notes,
                   seconds=round(time.time() - t0, 1))
        print(json.dumps(row), flush=True)
        out.append(row)
        del step, cell_args
    dist.destroy_process_group()
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
