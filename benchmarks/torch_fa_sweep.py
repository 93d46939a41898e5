"""Launch plans of the port's ``flash_attention`` kernels on the card.

  python3 benchmarks/torch_fa_sweep.py [--out results/torch/fa_sweep.json]

At SmolLM-135M's attention (4 slots, GQA 9/3, head_dim 64, a float32
cache of 256 rows, as the serving engine holds it), for a decode step
(one query at cache index 135) and a prefill step (130 queries from 0),
with float32 q (the served path) and bfloat16 q, times the wrapper's own
plan and other plans through the kernels' C entry: the split kernel
(CUDA cores) at other cluster sizes and row buckets, and, for prefill,
the tensor-core kernel (P V as three bf16 parts of P and of the float32
V) at other cluster sizes beside the split kernel.  Each plan is held to
the plain version within 2e-5 first.  A time is the mean device
time of one launch over 30 layers' tensors queued behind a sleep kernel,
so the events see the device only.  Prints one line per plan and writes
them all to ``--out``.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

B, HQ, HKV, D, MAX_LEN, LAYERS = 4, 9, 3, 64, 256, 30
PHASES = {"decode": (1, 135), "prefill": (130, 0)}
TOL = 2e-5   # tests/test_kernels.py:122
SLEEP_CYCLES = 20_000_000


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path,
                    default=ROOT / "results" / "torch" / "fa_sweep.json")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_fa_sweep needs a CUDA card")
    from repro_torch.kernels.flash_attention import plan as make_plan
    from repro_torch.kernels.flash_attention.flash_attention import (
        _TYPES, _Strides, _entry, _vec_ok)
    from repro_torch.kernels.flash_attention.ref import ref_attention_gqa

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    entry = _entry(False)     # SmolLM-135M's shapes: no window, no cap
    stream = torch.cuda.current_stream().cuda_stream
    rows = []

    def run(q, k, v, st, variant, rb, splits):
        b, sq, hq, d = q.shape
        out = torch.empty((b, sq, hq, d), device=dev)
        strides = [_Strides(*t.stride()[:3]) for t in (q, k, v, out)]
        rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   st.data_ptr(), _TYPES[q.dtype], _TYPES[k.dtype], b, sq,
                   k.shape[1], hq, k.shape[2], d, *strides, d ** -0.5, 1, 1,
                   0, 0.0, variant, rb, splits,
                   int(_vec_ok(k) and _vec_ok(v)), stream)
        if rc:
            raise RuntimeError(f"launch failed ({rc}) for {variant, rb, splits}")
        return out

    for q_name in ("float32", "bfloat16"):
        q_type = getattr(torch, q_name)
        for phase, (sq, start) in PHASES.items():
            q = torch.randn((LAYERS, B, sq, HQ, D), generator=gen,
                            device=dev).to(q_type)
            kv = torch.randn((2, LAYERS, B, MAX_LEN, HKV, D), generator=gen,
                             device=dev)
            st = torch.full((B,), start, dtype=torch.int32, device=dev)
            own = make_plan(B, sq, MAX_LEN, HQ, HKV, D,
                            q_type == torch.bfloat16)
            cands = [(0, rb, s) for rb in (4, 8) for s in (1, 2, 4, 6, 8)]
            if phase == "prefill":
                cands = [(1, 64, s) for s in (1, 2, 3, 4)] + [
                    (0, 8, s) for s in (1, 2, 4)]
            for variant, rb, splits in cands:
                want = ref_attention_gqa(q[0], kv[0, 0], kv[1, 0], st,
                                         round_p=True)
                got = run(q[0], kv[0, 0], kv[1, 0], st, variant, rb, splits)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                if not err <= TOL:
                    raise SystemExit(f"{phase} {q_name} {variant, rb, splits}:"
                                     f" differs from plain by {err}")

                def layers():
                    for i in range(LAYERS):
                        run(q[i], kv[0, i], kv[1, i], st, variant, rb, splits)

                layers()
                torch.cuda.synchronize()
                times = []
                for _ in range(5):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    torch.cuda._sleep(SLEEP_CYCLES)
                    a.record()
                    layers()
                    b.record()
                    torch.cuda.synchronize()
                    times.append(a.elapsed_time(b) / LAYERS * 1e3)
                us = sorted(times)[len(times) // 2]
                name = {0: "split", 1: "mma"}[variant]
                mine = (name == own.variant and rb == own.rows
                        and splits == own.splits)
                rows.append(dict(phase=phase, q=q_name, kernel=name, rows=rb,
                                 splits=splits, us_per_launch=us,
                                 max_abs_err=err, plan=mine))
                print(f"{phase:7s} q {q_name:8s} {name:7s} rows {rb:2d} "
                      f"splits {splits}: {us:8.3f} us a launch, err {err:.3g}"
                      + ("  <- plan" if mine else ""))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))


if __name__ == "__main__":
    main()
