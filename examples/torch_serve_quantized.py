"""Serve a model with QADAM-quantized (packed) weights on the PyTorch/CUDA
port: the DSE-chosen PE type applied at inference, with every packed
projection read by the hand-written ``quant_matmul`` kernel and every
attention by ``flash_attention`` on the card.

  PYTHONPATH=src python examples/torch_serve_quantized.py --pe-type lightpe1
      [--size full|reduced] [--device cpu]

The counterpart of examples/serve_quantized.py (same flags, same
``min_size`` of 1024, 4 slots, max_len 64, 8-token prompts from
``default_rng(0)``), at SmolLM-135M's full width by default.  The weights
are random: drawn with numpy from seed 0 at the reference's init scales.
"""

import argparse
import subprocess
import time

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import get, reduced
from repro_torch.models import family_module
from repro_torch.serve import ServeEngine, packed_bytes, quantize_params


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--pe-type", default="lightpe1",
                    choices=("lightpe1", "lightpe2", "int8", "int4"))
    ap.add_argument("--prompts", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--size", default="full", choices=("full", "reduced"))
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args()

    cfg = (get if args.size == "full" else reduced)(args.arch)
    mod = family_module(cfg)
    arrays = mod.numpy_params(cfg, seed=0)
    dense_bytes = sum(a.nbytes for a in _leaves(arrays))
    params = convert.params_from_numpy(arrays, args.device)

    packed = quantize_params(params, args.pe_type, min_size=1 << 10)
    pb = packed_bytes(packed)
    print(f"{cfg.name} ({args.size}) {args.pe_type}: packed {pb / 1e6:.2f} MB "
          f"vs dense f32 {dense_bytes / 1e6:.2f} MB -> "
          f"{dense_bytes / pb:.1f}x less device memory "
          f"(bf16 baseline: {dense_bytes / 2 / pb:.1f}x)")

    eng = ServeEngine(cfg, mod, packed, batch_slots=4, max_len=64)
    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(0, cfg.vocab, size=8),
                       max_new=args.max_new) for _ in range(args.prompts)]
    on_card = eng.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run()
    if on_card:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    tokens = sum(len(r.out) for r in reqs)
    where = card_line() if on_card else "CPU, plain versions of the kernels"
    print(f"served {tokens} tokens in {dt:.2f}s ({tokens / dt:.1f} tok/s, "
          f"first run, on {where})")
    for i, r in enumerate(reqs[:2]):
        print(f"  req{i}: {r.out}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    main()
