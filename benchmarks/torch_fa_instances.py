"""The ``flash_attention`` kernel's device time at every served model's
shapes, for a comparison of two trees in one call.

  python3 benchmarks/torch_fa_instances.py [--src OTHER/src] [--out JSON]

Times the wrapper's own plan (one launch a call, the served types: float32
q, K, V on the engine's float32 cache) at SmolLM-135M's decode and
prefill (head_dim 64), Gemma-3-1B's and Gemma-2-9B's windowed shapes
(head_dim 256), Whisper-medium's encoder and cross attention (no mask),
and Zamba2-7B's shared attention (head_dim 112; a tree without that
instance skips it).  ``--src`` takes the package from another checkout's
``src`` (its kernels build under that checkout's ``build/``), so the
parent and the change run on one card in one call: run parent, change,
change, parent.  Each time is the mean of 20 launches queued behind a
sleep kernel (CUDA events, device time only); each result is held to the
plain version within 2e-5 first.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-5   # tests/test_kernels.py:122
SLEEP_CYCLES = 20_000_000
# (name, b, sq, skv, hq, hkv, d, start, causal, window, softcap, scale)
SHAPES = [
    ("smollm decode", 4, 1, 256, 9, 3, 64, 135, True, 0, 0.0, 0.0),
    ("smollm prefill", 4, 130, 256, 9, 3, 64, 0, True, 0, 0.0, 0.0),
    ("gemma3 decode", 4, 1, 1024, 4, 1, 256, 905, True, 512, 0.0, 0.0),
    ("gemma3 prefill", 4, 900, 1024, 4, 1, 256, 0, True, 512, 0.0, 0.0),
    ("gemma2 decode", 1, 1, 4608, 16, 8, 256, 4607, True, 4096, 50.0,
     1 / 16),
    ("whisper encoder", 4, 1500, 1500, 16, 16, 64, 0, False, 0, 0.0, 0.0),
    ("whisper cross decode", 4, 1, 1500, 16, 16, 64, 0, False, 0, 0.0, 0.0),
    ("zamba2 prefill", 4, 130, 256, 32, 32, 112, 0, True, 0, 0.0, 0.0),
    ("zamba2 decode", 4, 1, 256, 32, 32, 112, 130, True, 0, 0.0, 0.0)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    from repro_torch.kernels.flash_attention import plan as fa_plan
    from repro_torch.kernels.flash_attention.ref import ref_attention_gqa
    from repro_torch.kernels.flash_attention import flash_attention as fa_mod

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    _build.build(("flash_attention",))
    heads = sys.modules[fa_mod.__module__]._HEAD_DIMS
    print(f"card: {card}; src {args.src}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for name, b, sq, skv, hq, hkv, d, start, causal, window, softcap, \
            scale in SHAPES:
        if d not in heads:
            print(f"{name}: head_dim {d} not in this tree's kernel")
            continue
        q = torch.randn((b, sq, hq, d), generator=gen, device=dev)
        k = torch.randn((b, skv, hkv, d), generator=gen, device=dev)
        v = torch.randn((b, skv, hkv, d), generator=gen, device=dev)
        st = torch.full((b,), start, dtype=torch.int32, device=dev)
        kw = dict(causal=causal, scale=scale, window=window,
                  softcap=softcap)
        got = flash_attention_gqa(q, k, v, st, **kw)
        want = ref_attention_gqa(q, k, v, st, causal, scale, False, window,
                                 softcap)
        err = float((got - want).abs().max())
        if err > TOL:
            raise SystemExit(f"{name}: differs from plain by {err}")
        for _ in range(3):
            flash_attention_gqa(q, k, v, st, **kw)
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(SLEEP_CYCLES)
        t0.record()
        for _ in range(20):
            flash_attention_gqa(q, k, v, st, **kw)
        t1.record()
        torch.cuda.synchronize()
        ms = t0.elapsed_time(t1) / 20
        p = fa_plan(b, sq, skv, hq, hkv, d, False, window)
        rows.append(dict(name=name, ms=ms, max_abs_err=err,
                         variant=p.variant, splits=p.splits, card=card,
                         src=str(args.src)))
        print(f"{name} ({p.variant}, {p.splits} splits): {ms:.4f} ms, "
              f"max_abs_err {err:.3g}")
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1) + "\n")


if __name__ == "__main__":
    main()
