"""Launch plans of the port's ``quant_matmul`` kernel on the card.

  python3 benchmarks/torch_qmm_sweep.py [--out results/torch/qmm_sweep.json]

At SmolLM-135M's four projection shapes (K, N), for decode (M = 4) and
prefill (M = 4 * 130) with the x type each projection takes on the serving
path (bfloat16; float32 for w_down), times the wrapper's own plan and a
grid of other plans (GEMV: threads along N x splits; tensor cores:
splits) through the kernel's C entry, each held to the plain version
within rtol 1e-5 / atol 1e-4.  A time is the mean device time of one
launch over 30 layers' codes (pow2, random weights) queued behind a sleep
kernel, so the events see the device only.  Prints one line per plan and
writes them all to ``--out``.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

SHAPES = {"wq/wo": (576, 576, "bf16"), "wk/wv": (576, 192, "bf16"),
          "w_up/w_gate": (576, 1536, "bf16"), "w_down": (1536, 576, "f32")}
LAYERS = 30


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path,
                    default=ROOT / "results" / "torch" / "qmm_sweep.json")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_qmm_sweep needs a CUDA card")
    from repro_torch.kernels.quant_matmul import plan as make_plan
    from repro_torch.kernels.quant_matmul.quant_matmul import (Plan, _ceil,
                                                               _entry)
    from repro_torch.kernels.quant_matmul.ref import ref_quant_matmul
    from repro_torch.quant.pack import quantize_pow2

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    entry = _entry()
    stream = torch.cuda.current_stream().cuda_stream
    rows = []

    def run(x, codes, scale, p):
        m, k = x.shape
        n = codes.shape[1]
        out = torch.empty((m, n), device=dev)
        rc = entry(x.data_ptr(), int(x.dtype == torch.bfloat16),
                   codes.data_ptr(), scale.data_ptr(), out.data_ptr(), m, k,
                   n, 1, {"gemv": 0, "mma": 1}[p.variant], p.vec, p.tile,
                   p.splits, p.span, 0, stream)
        if rc:
            raise RuntimeError(f"launch failed ({rc}) for {p}")
        return out

    for name, (k, n, xt) in SHAPES.items():
        w = torch.randn((LAYERS, k, n), generator=gen, device=dev) * 0.05
        codes, scale = quantize_pow2(w)
        for m in (4, 520):
            x = torch.randn((m, k), generator=gen, device=dev).to(
                torch.bfloat16 if xt == "bf16" else torch.float32)
            own = make_plan(m, k, n, "pow2")
            rows_k = k // 2
            if own.variant == "gemv":
                cands = []
                for tn in (2, 4, 8, 16):
                    for s in (1, 2, 3, 4, 5, 6, 8):
                        span = _ceil(rows_k, s)
                        s2 = _ceil(rows_k, span)
                        cands.append(Plan("gemv", 16, tn, s2, span,
                                          (_ceil(n, 16 * tn), s2, 1)))
            else:
                tiles = _ceil(k, 32)
                cands = []
                for s in (1, 2, 3, 4, 5, 6, 8):
                    span = _ceil(tiles, s)
                    s2 = _ceil(tiles, span)
                    cands.append(Plan("mma", 16, 64, s2, span,
                                      (_ceil(n, 64), _ceil(m, 64), s2)))
            seen = set()
            for p in [own] + cands:
                key = (p.tile, p.splits, p.span)
                if key in seen:
                    continue
                seen.add(key)
                want = ref_quant_matmul(x, codes[0], scale[0], "pow2")
                got = run(x, codes[0], scale[0], p)
                torch.cuda.synchronize()
                if not torch.allclose(got, want, rtol=1e-5, atol=1e-4):
                    raise SystemExit(f"{name} M={m} {p}: differs from plain "
                                     f"by {float((got - want).abs().max())}")
                for i in range(LAYERS):   # warm-up
                    run(x, codes[i], scale[i], p)
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(20_000_000)
                start.record()
                for i in range(LAYERS):
                    run(x, codes[i], scale[i], p)
                end.record()
                torch.cuda.synchronize()
                us = start.elapsed_time(end) / LAYERS * 1e3
                row = dict(shape=name, m=m, k=k, n=n, x=xt,
                           variant=p.variant, tile=p.tile, splits=p.splits,
                           span=p.span, blocks=p.grid[0] * p.grid[1]
                           * p.grid[2], us=us, own=p == own)
                rows.append(row)
                print(f"{name:12s} M={m:3d} {p.variant} tile={p.tile:3d} "
                      f"splits={p.splits} blocks={row['blocks']:4d} "
                      f"{us:8.3f} us{'  <- plan' if p == own else ''}")
    # the floor: 30 launches of a one-block fill kernel, queued the same way
    buf = torch.empty(4 * 576, device=dev)
    buf.zero_()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(LAYERS):
        buf.zero_()
    end.record()
    torch.cuda.synchronize()
    floor = start.elapsed_time(end) / LAYERS * 1e3
    print(f"floor: a one-block fill kernel {floor:.3f} us a launch")
    rows.append(dict(shape="fill (floor)", us=floor))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(card=card, rows=rows), indent=1))


if __name__ == "__main__":
    main()
