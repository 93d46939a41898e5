"""Serving launcher CLI (port of ``repro.launch.serve``): batched
generation, optionally on QADAM-quantized weights.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --reduced --pe-type lightpe1 --prompts 4 --max-new 16 [--device cpu]

As the reference, ``--pe-type`` packs the weights (and prints the packed
against the dense bytes), then serves the DEQUANTIZED dense weights.
It runs on the card unless ``--device cpu`` says otherwise, and prints
the reference's lines: the packing, ``served ... tok/s``, and the first
four requests' tokens.  ``main(argv)`` returns the requests.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get as get_cfg, reduced as get_reduced, list_archs
from repro_torch.device import resolve_device
from repro_torch.models import family_module
from repro_torch.serve import (ServeEngine, dequantize_params, packed_bytes,
                               quantize_params)

ENCDEC = (
    "the reference's serving launcher cannot serve an encoder-decoder "
    "model: its ServeEngine passes a token array where the model reads "
    "batch['frames'] and raises TypeError: JAX does not support string "
    "indexing; got idx='frames' (ROADMAP C); serve Whisper through "
    "serve.check.record_encdec")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--pe-type", default=None,
                    help="serve with packed quantized weights")
    ap.add_argument("--prompts", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; cpu runs "
                         "the kernels' plain versions)")
    return ap


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None):
    args = parser().parse_args(argv)
    cfg = get_reduced(args.arch) if args.reduced else get_cfg(args.arch)
    if cfg.family == "encdec":
        raise NotImplementedError(ENCDEC)
    mod = family_module(cfg)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = mod.init_params(cfg, gen, device=device)

    if args.pe_type and args.pe_type != "fp32":
        t0 = time.time()
        packed = quantize_params(params, args.pe_type)
        params = dequantize_params(packed)
        _sync(device)
        pb, fb = packed_bytes(packed), packed_bytes(params)
        print(f"packed weights: {pb / 1e6:.1f} MB vs dense {fb / 1e6:.1f} MB "
              f"({fb / max(pb, 1):.1f}x HBM saving), quantize "
              f"{time.time() - t0:.1f}s")

    eng = ServeEngine(cfg, mod, params, batch_slots=args.slots,
                      max_len=args.max_len)
    rng = np.random.default_rng(args.seed)
    reqs = [eng.submit(rng.integers(0, cfg.vocab, size=args.prompt_len),
                       max_new=args.max_new) for _ in range(args.prompts)]
    t0 = time.time()
    iters = eng.run()
    _sync(device)
    dt = time.time() - t0
    total_tokens = sum(len(r.out) for r in reqs)
    print(f"served {len(reqs)} requests, {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens / max(dt, 1e-9):.1f} tok/s, {iters} engine iters)")
    for i, r in enumerate(reqs[:4]):
        print(f"  req{i}: {r.out}")
    return reqs


if __name__ == "__main__":
    main()
