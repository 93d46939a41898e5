"""Times of the port's ``fake_quant`` kernel on the card, per shape and
grouped, against the memory bound.

  python3 benchmarks/torch_fq_sweep.py [--out results/torch/fq_sweep.json]
                                      [--src DIR]

For each of VGG-16/CIFAR-10's weight shapes and for the 15 weights as
one group (one launch) and one by one (15 launches), in
float32 and bfloat16, affine-8 and pow2: the mean device time of a call,
queued behind a sleep kernel so the events see the device only, warm
(calls back to back) and with the L2 cache flushed before each call; each
output is first held to the plain version (0 differing elements).  The bound is the
bytes (each element read and written once, plus the scales) over the
H100 SXM's 3.35 TB/s.  Prints one line per row and writes them all, with
the card's name and power limit, to ``--out``.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

VGG16_SHAPES = [(27, 64), (576, 64), (576, 128), (1152, 128), (1152, 256),
                (2304, 256), (2304, 256), (2304, 512)] + [(4608, 512)] * 5 \
    + [(512, 512), (512, 10)]
MODES = [("affine", 8), ("pow2", 8)]
H100_BYTES_PER_S = 3.35e12
REPS = 20


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path,
                    default=ROOT / "results" / "torch" / "fq_sweep.json")
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_fq_sweep needs a CUDA card")
    from repro_torch.kernels import fake_quant as kernel
    from repro_torch.kernels.fake_quant.ref import (ref_fake_quant_affine,
                                                    ref_fake_quant_pow2)
    from repro_torch.quant.fake_quant import affine_scale, pow2_emax
    from repro_torch.quickstart import draw_weights

    fake_quant = kernel.fake_quant
    grouped = hasattr(kernel, "fake_quant_group")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"card: {card}; repro_torch from {kernel.__file__}")
    dev = torch.device("cuda")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def device_ms(fn, cold):
        fn()
        torch.cuda.synchronize()
        total = 0.0
        reps = REPS if cold else 1
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(200_000_000 if not cold else 20_000_000)
            if cold:
                flush.zero_()
            start.record()
            for _ in range(1 if cold else REPS):
                fn()
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
        return total / REPS

    base = draw_weights(VGG16_SHAPES, seed=1, device=dev)
    rows = []
    for dtype in (torch.float32, torch.bfloat16) if grouped else (
            torch.float32,):
        ws = [w.to(dtype) for w in base]
        elem = ws[0].element_size()
        for mode, bits in MODES:
            scales = [(affine_scale(w, bits, axis=0) if mode == "affine"
                       else pow2_emax(w, axis=0))[0] for w in ws]
            plain = (lambda w, s: ref_fake_quant_affine(w, s, bits)) \
                if mode == "affine" else ref_fake_quant_pow2
            got = [fake_quant(w, s, mode=mode, bits=bits)
                   for w, s in zip(ws, scales)]
            if grouped:
                got += kernel.fake_quant_group(ws, scales, mode=mode, bits=bits)
            for g, w, s in zip(got, ws + ws, scales + scales):
                if not torch.equal(g, plain(w, s)):
                    raise SystemExit(f"fake_quant {dtype} {mode}: differs "
                                     f"from plain at {tuple(w.shape)}")
            cases = [(f"{k}x{n}", [i]) for i, (k, n) in enumerate(VGG16_SHAPES)
                     if (k, n) not in VGG16_SHAPES[:i]]
            cases += [("15 one by one", list(range(len(ws))))]
            if grouped:
                cases += [("group of 15", list(range(len(ws))))]
            else:
                cases = cases[-1:]
            for name, idx in cases:
                sub = [ws[i] for i in idx]
                sc = [scales[i] for i in idx]
                if name == "15 one by one":
                    fn = lambda sub=sub, sc=sc: [  # noqa: E731
                        fake_quant(w, s, mode=mode, bits=bits)
                        for w, s in zip(sub, sc)]
                else:
                    fn = lambda sub=sub, sc=sc: kernel.fake_quant_group(  # noqa: E731
                        sub, sc, mode=mode, bits=bits)
                nbytes = sum(w.numel() * 2 * elem + w.shape[1] * elem
                             for w in sub)
                row = dict(dtype=str(dtype).split(".")[-1], mode=mode,
                           bits=bits, case=name, elements=sum(
                               w.numel() for w in sub), bytes=nbytes,
                           ms=device_ms(fn, cold=False),
                           cold_ms=device_ms(fn, cold=True),
                           bound_ms=nbytes / H100_BYTES_PER_S * 1e3)
                row["bound_share"] = row["bound_ms"] / row["ms"]
                rows.append(row)
                print(f"{row['dtype']} {mode}{bits} {name}: {row['ms']:.4f} "
                      f"ms warm, {row['cold_ms']:.4f} ms L2 flushed, bound "
                      f"{row['bound_ms']:.4f} ms ({row['bound_share']:.2f} "
                      f"of it warm)")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(card=card, src=str(args.src),
                                        grouped=grouped, rows=rows),
                                   indent=1))


if __name__ == "__main__":
    main()
