"""Perf variants of four dry-run cells (port of ``repro.launch.perf``).

Each chosen cell has an ordered list of variants, cumulative as in the
reference: a variant is ``ArchConfig`` overrides plus step options
(``serve_quant``: weights packed by ``serve.engine.quantize_params``;
``cache_dtype``: the KV cache's type; under the config's
``mixed_precision`` the step runs in the ``layers.compute_dtype``
context).  Each is built and counted on ``meta`` as the dry run counts a
cell (``dryrun.train_cell`` / ``dryrun.serve_cell``, one rank of the
production mesh over the fake process group), and written to
``results/torch_perf/<arch>__<shape>__<variant>.json``.  Serving
variants keep float32 weights, as the reference's runner does, unless
they are packed.  The fp8 cache variants (``v1b_f8_cache_seqshard``,
``v3_f8_cache``) count as the others do: ``flash_attention`` takes
float8_e4m3fn K and V (read at a byte an element).  The cache is split
as the reference's runner splits it (``cache_spec(..., seq_shard)``, in
``dryrun.serve_cell``): ``v1b_f8_cache_seqshard``'s 8 KV heads do not
divide 16, so its cache splits its sequence and each rank attends over
its slice of the keys.  A variant that fails is recorded as ``status:
error`` with its message.  No card is
needed:

  PYTHONPATH=src python -m repro_torch.launch.perf \\
      [--cell qwen3-32b:decode_32k] [--variant v2_int4_weights]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import get as get_cfg
from repro_torch.launch import dryrun as D
from repro_torch.launch import shapes as SH
from repro_torch.models import family_module
from repro_torch.models.layers import compute_dtype

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "torch_perf"

# The reference's cells and variants, variant for variant
CELLS = {
    ("deepseek-moe-16b", "train_4k"): [
        ("v1_bf16_compute", dict(mixed_precision=True), {}),
        ("v2_ep_shard_map",
         dict(mixed_precision=True, moe_ep_shard_map=True), {}),
        ("v3_int8_dispatch",
         dict(mixed_precision=True, moe_ep_shard_map=True,
              moe_ep_int8_payload=True), {}),
    ],
    ("gemma3-1b", "train_4k"): [
        ("v1_bf16_compute", dict(mixed_precision=True), {}),
        ("v2_block_local_attn",
         dict(mixed_precision=True, attn_block_local=True), {}),
    ],
    ("qwen3-32b", "prefill_32k"): [
        ("v1_flash_prefill", dict(attn_flash=True), {}),
    ],
    ("qwen3-32b", "decode_32k"): [
        ("v0_native_dtype_attn", dict(), {}),
        ("v1_kv_pad_tp", dict(kv_replicate_to=16), {}),
        ("v1b_f8_cache_seqshard", dict(),
         {"cache_dtype": "float8_e4m3fn"}),
        ("v2_int4_weights", dict(kv_replicate_to=16),
         {"serve_quant": "int4"}),
        ("v3_f8_cache", dict(kv_replicate_to=16),
         {"serve_quant": "int4", "cache_dtype": "float8_e4m3fn"}),
    ],
}


def build_variant(arch, shape_name, mesh, cfg_overrides, options):
    """(cfg, step, args) of one variant on ``meta``: the arch's config
    with the overrides."""
    cfg = get_cfg(arch).replace(**cfg_overrides)
    shape = SH.SHAPES[shape_name]
    if shape.kind == "train":
        step, args = D.train_cell(cfg, shape, mesh)
        return cfg, step, args
    mod = family_module(cfg)
    params = D.serve_params(cfg, mod, "meta", bf16=False,
                            serve_quant=options.get("serve_quant"))
    dtype = getattr(torch, options.get("cache_dtype", "bfloat16"))
    cache = mod.init_cache(cfg, shape.batch, shape.seq, dtype, device="meta")
    step, args = D.serve_cell(cfg, shape, mesh, params=params, cache=cache)
    return cfg, step, args


def run_variant(arch, shape_name, vname, cfg_overrides, options,
                multi_pod=False, *, mesh_shape=None) -> dict:
    """Count one variant as rank 0 of the production mesh (or
    ``mesh_shape`` = (sizes, axes)) and save it (``results/torch_perf/``)."""
    sizes, axes = mesh_shape or D.MESHES["pod2x16x16" if multi_pod
                                         else "pod16x16"]
    result = {"arch": arch, "shape": shape_name, "variant": vname,
              "mesh": D.mesh_name(sizes),
              "overrides": {k: str(v) for k, v in cfg_overrides.items()},
              "options": options}
    t0 = time.time()
    try:
        mesh = D.start_mesh(sizes, axes)
        cfg_v, step, args = build_variant(arch, shape_name, mesh,
                                          cfg_overrides, options)
        ctx = (compute_dtype(getattr(torch, cfg_v.dtype))
               if cfg_v.mixed_precision else contextlib.nullcontext())
        with ctx:
            counts = D.analyze_cell(step, args)
        result.update(status="ok", seconds=round(time.time() - t0, 1),
                      **counts)
        print(f"[{arch} x {shape_name} x {vname}] OK "
              f"flops={result['flops']:.4e} bytes={result['bytes_out']:.4e} "
              f"coll={result['collectives']['total'] / 1e9:.3f}GB "
              f"args={result['memory']['argument_size_in_bytes'] / 1e9:.3f}GB")
    except Exception as e:  # noqa: BLE001 -- failures are recorded as data
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"[:1500]
        result["traceback"] = traceback.format_exc()[-3000:]
        print(f"[{arch} x {shape_name} x {vname}] FAIL "
              f"{result['error'][:200]}")
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    (RESULTS_DIR / f"{arch}__{shape_name}__{vname}.json").write_text(
        json.dumps(result, indent=1))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default=None,
                    help="arch:shape (default: all four)")
    ap.add_argument("--variant", default=None)
    args = ap.parse_args(argv)
    ok = True
    try:
        for (arch, shape), variants in CELLS.items():
            if args.cell and args.cell != f"{arch}:{shape}":
                continue
            for vname, overrides, options in variants:
                if args.variant and args.variant != vname:
                    continue
                r = run_variant(arch, shape, vname, overrides, options)
                ok = ok and r["status"] == "ok"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    raise SystemExit(0 if ok else 1)


if __name__ == "__main__":
    main()
