"""The ``flash_attention`` kernel's device time at every served model's
shapes, for a comparison of two trees in one call.

  python3 benchmarks/torch_fa_instances.py [--src OTHER/src] [--out JSON]
                                           [--only NAME ...]

Times the wrapper's own plan (one launch a call, the served types: float32
K, V on the engine's float32 cache; float32 q, and bfloat16 q where the
name says so) at SmolLM-135M's decode and prefill (head_dim 64),
Gemma-3-1B's and Gemma-2-9B's windowed shapes (head_dim 256: decode, the
served prefills, Gemma-3-1B's block-local layer over 2 x 1024 positions
and Gemma-2-9B's prefill of 4,608 tokens with its soft-cap), Whisper-medium's
encoder and cross attention (no mask), and Zamba2-7B's shared attention
(head_dim 112; with a bfloat16 q also at the training shape 2 x 512).
A shape whose head_dim, window or soft-cap another tree's kernel does not
take is skipped.  Where the plan runs the wgmma kernel, its packing
launch's device time (``torch.profiler``) is given apart; where it runs
the mma kernel at a head_dim the wgmma kernel also takes (a bfloat16 q at
112 or 128), the wgmma kernel is timed too on the same inputs (the plan's
variant swapped), to show which of the two the plan should take.
``--src`` takes the package from another checkout's ``src`` (its kernels
build under that checkout's ``build/``), so the parent and the change run
on one card in one call: run parent, change, change, parent.  Each time is the mean of 20 launches queued
behind a sleep kernel (CUDA events, device time only); each result is
held to the plain version within 2e-5 first.
"""

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TOL = 2e-5   # tests/test_kernels.py:122
SLEEP_CYCLES = 20_000_000
# (name, b, sq, skv, hq, hkv, d, start, causal, window, softcap, scale,
# q type)
SHAPES = [
    ("smollm decode", 4, 1, 256, 9, 3, 64, 135, True, 0, 0.0, 0.0, "f32"),
    ("smollm prefill", 4, 130, 256, 9, 3, 64, 0, True, 0, 0.0, 0.0, "f32"),
    ("gemma3 decode", 4, 1, 1024, 4, 1, 256, 905, True, 512, 0.0, 0.0,
     "f32"),
    ("gemma3 prefill", 4, 900, 1024, 4, 1, 256, 0, True, 512, 0.0, 0.0,
     "f32"),
    ("gemma3 prefill bf16 q", 4, 900, 1024, 4, 1, 256, 0, True, 512, 0.0,
     0.0, "bf16"),
    ("gemma3 block-local", 2, 1024, 1024, 4, 1, 256, 0, True, 512, 0.0,
     0.0, "f32"),
    ("gemma2 decode", 1, 1, 4608, 16, 8, 256, 4607, True, 4096, 50.0,
     1 / 16, "f32"),
    ("gemma2 prefill", 1, 4608, 4608, 16, 8, 256, 0, True, 4096, 50.0,
     1 / 16, "f32"),
    ("gemma2 prefill bf16 q", 1, 4608, 4608, 16, 8, 256, 0, True, 4096,
     50.0, 1 / 16, "bf16"),
    ("whisper encoder", 4, 1500, 1500, 16, 16, 64, 0, False, 0, 0.0, 0.0,
     "f32"),
    ("whisper cross decode", 4, 1, 1500, 16, 16, 64, 0, False, 0, 0.0, 0.0,
     "f32"),
    ("zamba2 prefill", 4, 130, 256, 32, 32, 112, 0, True, 0, 0.0, 0.0,
     "f32"),
    ("zamba2 decode", 4, 1, 256, 32, 32, 112, 130, True, 0, 0.0, 0.0,
     "f32"),
    ("zamba2 prefill bf16 q", 4, 130, 256, 32, 32, 112, 0, True, 0, 0.0,
     0.0, "bf16"),
    ("zamba2 train bf16 q", 2, 512, 512, 32, 32, 112, 0, True, 0, 0.0, 0.0,
     "bf16")]


def device_ms(torch, call) -> float:
    """Mean device time of 20 calls queued behind a sleep kernel."""
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(SLEEP_CYCLES)
    t0.record()
    for _ in range(20):
        call()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / 20


def pack_ms(torch, call) -> float:
    """Mean device time of a call's packing launch (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            call()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()
               if "pack_kernel" in e.key) / 20 / 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--only", nargs="*", default=None)
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
    _build.build(tuple(n for n in _build.SOURCES
                       if n.startswith("flash_attention")
                       and "bwd" not in n))
    mod = sys.modules[fa_mod.__module__]
    heads = mod._HEAD_DIMS
    masks = "softcap" in inspect.signature(flash_attention_gqa).parameters
    print(f"card: {card}; src {args.src}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for name, b, sq, skv, hq, hkv, d, start, causal, window, softcap, \
            scale, q_type in SHAPES:
        if args.only and name not in args.only:
            continue
        if d not in heads or (not masks and (window or softcap)):
            print(f"{name}: not taken by this tree's kernel")
            continue
        q = torch.randn((b, sq, hq, d), generator=gen, device=dev)
        if q_type == "bf16":
            q = q.to(torch.bfloat16)
        k = torch.randn((b, skv, hkv, d), generator=gen, device=dev)
        v = torch.randn((b, skv, hkv, d), generator=gen, device=dev)
        st = torch.full((b,), start, dtype=torch.int32, device=dev)
        kw = dict(causal=causal, scale=scale)
        if masks:
            kw.update(window=window, softcap=softcap)
        got = flash_attention_gqa(q, k, v, st, **kw)
        want = ref_attention_gqa(q, k, v, st, causal, scale, False,
                                 *([window, softcap] if masks else []))
        err = float((got - want).abs().max())
        del got
        if err > TOL:
            raise SystemExit(f"{name}: differs from plain by {err}")
        call = lambda: flash_attention_gqa(q, k, v, st, **kw)  # noqa: E731
        ms = device_ms(torch, call)
        p = fa_plan(b, sq, skv, hq, hkv, d, q_type == "bf16",
                    *([window] if masks else []))
        row = dict(name=name, ms=ms, max_abs_err=err, variant=p.variant,
                   splits=p.splits, card=card, src=str(args.src))
        if p.variant == "wgmma":
            row["pack_ms"] = pack_ms(torch, call)
        elif p.variant == "mma" and d in getattr(mod, "WGMMA_DIMS", ()):
            plan_of = mod.plan
            mod.plan = lambda *a: plan_of(*a)._replace(variant="wgmma")
            try:
                werr = float((call() - want).abs().max())
                if werr > TOL:
                    raise SystemExit(f"{name} on wgmma: differs from plain "
                                     f"by {werr}")
                row.update(wgmma_ms=device_ms(torch, call),
                           wgmma_pack_ms=pack_ms(torch, call),
                           wgmma_max_abs_err=werr)
            finally:
                mod.plan = plan_of
        del want
        rows.append(row)
        extra = "".join(f", {key} {row[key]:.4f}" for key in
                        ("pack_ms", "wgmma_ms", "wgmma_pack_ms") if key in row)
        print(f"{name} ({p.variant}, {p.splits} splits): {ms:.4f} ms"
              f"{extra}, max_abs_err {err:.3g}", flush=True)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1) + "\n")


if __name__ == "__main__":
    main()
