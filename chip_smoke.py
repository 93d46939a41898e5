#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

  python3 chip_smoke.py

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles every CUDA source of the port with nvcc (in parallel);
3. kernel vs plain: ``fake_quant`` (affine at 4/8/16 bits, pow2) on the
   15 VGG-16/CIFAR-10 weight shapes and two ragged ones, held to its
   plain torch version on the same tensors within 1e-6, and timed beside
   the plain version, ``torch.fake_quantize_per_channel_affine`` and the
   memory bound;
4. the slice: the quickstart loop at full size on the card (27,000-point
   paper grid, VGG-16/CIFAR-10, oracle and surrogate DSE, Pareto, report,
   best LightPE-1 design, every preset's fake quantization of VGG-16's
   weights), with kernel launches counted over that run and the results
   held to ``tests/data/torch_quickstart_ref.json`` (the JAX package's);
   then a 2^20-point subsample of WIDE_SPACE in 65,536-point chunks;
5. prints a ``{"kernels": [...]}`` line and, last, the device line.

Any failed phase exits non-zero before the last line is printed.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REF = ROOT / "tests" / "data" / "torch_quickstart_ref.json"

# (R*S*C, K) of VGG-16/CIFAR-10's 15 layers, and two ragged shapes.
VGG16_SHAPES = [(27, 64), (576, 64), (576, 128), (1152, 128), (1152, 256),
                (2304, 256), (2304, 256), (2304, 512)] + [(4608, 512)] * 5 \
    + [(512, 512), (512, 10)]
RAGGED_SHAPES = [(300, 190), (1, 129)]
KERNEL_MODES = [("affine", 4), ("affine", 8), ("affine", 16), ("pow2", 8)]
KERNEL_TOL = 1e-6
H100_BYTES_PER_S = 3.35e12      # HBM3 of the H100 SXM (NVIDIA data sheet)
SLEEP_CYCLES = 200_000_000      # ~0.1 s at the H100's ~1.98 GHz clock
WIDE_POINTS = 2 ** 20
WIDE_CHUNK = 65536


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAIL: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int = 5, warmup: int = 2,
            queued: bool = True) -> float:
    """Mean milliseconds of ``fn()`` on the current stream (CUDA events).

    ``queued``: the stream is held by a sleep kernel while the host queues
    all ``reps`` calls, so the events see device time only, without the
    gaps of a host slower than the device (the host-paced time is what
    ``queued=False`` gives).
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_kernels(torch, dev):
    """Phase 3: fake_quant against its plain version, and its times."""
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.kernels.fake_quant.ref import (ref_fake_quant_affine,
                                                    ref_fake_quant_pow2)
    from repro_torch.quant.fake_quant import affine_scale, pow2_emax
    from repro_torch.quickstart import draw_weights

    weights = draw_weights(VGG16_SHAPES + RAGGED_SHAPES, seed=1, device=dev)
    vgg = weights[:len(VGG16_SHAPES)]
    bytes_moved = sum(w.numel() * 8 + w.shape[1] * 4 for w in vgg)
    bound_ms = bytes_moved / H100_BYTES_PER_S * 1e3
    modes = []
    for mode, bits in KERNEL_MODES:
        if mode == "affine":
            scales = [affine_scale(w, bits, axis=0)[0] for w in weights]
            plain = lambda w, s: ref_fake_quant_affine(w, s, bits)  # noqa: E731
        else:
            scales = [pow2_emax(w, axis=0)[0] for w in weights]
            plain = ref_fake_quant_pow2
        err, flips = 0.0, 0
        for w, s in zip(weights, scales):
            got = fake_quant(w, s, mode=mode, bits=bits)
            want = plain(w, s)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                fail(f"fake_quant {mode}{bits} {tuple(w.shape)}: non-finite")
            diff = (got - want).abs()
            err = max(err, float(diff.max()))
            if mode == "pow2":
                flips += int((got != want).sum())
        if flips:
            fail(f"fake_quant pow2: {flips} code flips against plain")
        if err > KERNEL_TOL:
            fail(f"fake_quant {mode}{bits}: max abs err {err} > {KERNEL_TOL}")
        pairs = list(zip(vgg, scales[:len(vgg)]))
        kernel = lambda: [fake_quant(w, s, mode=mode, bits=bits)  # noqa: E731
                          for w, s in pairs]
        ms = time_ms(torch, kernel)
        host_ms = time_ms(torch, kernel, queued=False)
        plain_ms = time_ms(torch, lambda: [plain(w, s) for w, s in pairs])
        library_ms = None
        if mode == "affine":
            qmax = 2 ** (bits - 1) - 1
            zps = [torch.zeros(w.shape[1], dtype=torch.int32, device=dev)
                   for w in vgg]
            library_ms = time_ms(torch, lambda: [
                torch.fake_quantize_per_channel_affine(w, s, z, 1, -qmax, qmax)
                for (w, s), z in zip(pairs, zps)])
        modes.append(dict(mode=mode, bits=bits, max_abs_err=err, ms=ms,
                          host_paced_ms=host_ms, plain_ms=plain_ms,
                          library_ms=library_ms, bound_ms=bound_ms))
        print(f"fake_quant {mode}{bits}: max_abs_err={err} kernel={ms:.4f} ms "
              f"(host-paced {host_ms:.4f} ms) "
              f"plain={plain_ms:.4f} ms library={library_ms} ms "
              f"bound={bound_ms:.4f} ms (15 VGG-16 weights, "
              f"{bytes_moved} bytes)")
    return modes


def run_slice(torch, dev):
    """Phase 4: the quickstart loop at full size, launches counted."""
    import numpy as np
    from repro_torch import quickstart
    from repro_torch.core import dse, workloads
    from repro_torch.core.arch import WIDE_SPACE, enumerate_space
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.quant import PE_TYPES

    fake_quant.launches = 0
    res = quickstart.run(max_points=None, presets=PE_TYPES, device=dev)
    launches = fake_quant.launches
    print(f"quickstart (cold): {json.dumps(res.timings)}")
    print(f"fake_quant launches on the path: {launches}")
    if launches == 0:
        fail("the quickstart loop launched no fake_quant kernel")

    print(f"PPA surrogate fit: R2 {json.dumps(res.r2)}")
    problems, notes = quickstart.compare(res, json.loads(REF.read_text()))
    for n in notes:
        print(f"tolerated: {n}")
    if problems:
        fail("quickstart differs from the JAX reference: " + "; ".join(problems))
    print(f"quickstart matches the JAX reference: front "
          f"{np.flatnonzero(res.front).tolist()}, best LightPE-1 "
          f"{res.best_config}")
    for pe, r in dse.report_pe_types(res.report).items():
        print(f"  {pe:9s} perf/area={r['norm_perf_per_area']:.4f}x "
              f"energy={r['norm_energy']:.4f}x (vs best INT16)")

    # step 6 outputs: finite, same shapes, LightPE-1 codes powers of two
    for p, ws in res.quantized.items():
        for w, q in zip(res.weights, ws):
            if q.shape != w.shape or not bool(torch.isfinite(q).all()):
                fail(f"{p}: bad fake-quantized weight {tuple(q.shape)}")
    for q in res.quantized["lightpe1"]:
        e = torch.log2(q.abs()[q != 0])
        if not bool((e == torch.round(e)).all()):
            fail("lightpe1 weights are not powers of two")

    # within the port: chunked == unchunked, tiled Pareto == sorted
    wl = workloads.vgg16("cifar10", device=dev)
    chunked = dse.evaluate_space(res.space, wl, chunk_size=4096)
    if not all(np.array_equal(a, b) for a, b in zip(chunked, res.oracle)):
        fail("chunked evaluate_space differs from the unchunked call")
    obj = torch.as_tensor(quickstart._objectives(res.oracle), device=dev)
    if not np.array_equal(dse.pareto_mask_tiled(obj).cpu().numpy(), res.front):
        fail("pareto_mask_tiled on the card differs from pareto_mask_2d")

    warm = quickstart.run(max_points=None, presets=PE_TYPES, device=dev)
    print(f"quickstart (warm): {json.dumps(warm.timings)}")

    # the sweep size users run: 2^20 points of WIDE_SPACE
    space = enumerate_space(WIDE_SPACE, max_points=WIDE_POINTS, seed=0,
                            device=dev)
    dse.evaluate_space(dse._slice_config(space, 0, WIDE_CHUNK), wl,
                       chunk_size=WIDE_CHUNK)  # warm-up chunk
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wide = dse.evaluate_space(space, wl, chunk_size=WIDE_CHUNK)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
    if len(wide.energy_j) != WIDE_POINTS or not all(
            np.isfinite(c).all() for c in wide):
        fail("WIDE_SPACE sweep: wrong shape or non-finite columns")
    lanes = 4096
    cpu_space = type(space)(*[f.cpu() for f in
                              dse._slice_config(space, 0, lanes)])
    on_cpu = dse.evaluate_space(
        cpu_space, workloads.vgg16("cifar10", device="cpu"))
    for f, a, b in zip(wide._fields, wide, on_cpu):
        if not np.allclose(a[:lanes], b, rtol=quickstart.RTOL, atol=0):
            fail(f"WIDE_SPACE sweep: {f} differs from the CPU evaluation")
    n_front = int(np.asarray(dse.pareto_front(wide)).sum())
    print(f"WIDE_SPACE sweep: {WIDE_POINTS} points in {dt:.3f} s = "
          f"{WIDE_POINTS / dt:.0f} points/s, peak device memory "
          f"{peak_mb:.1f} MiB, front {n_front} points")
    return launches


def main() -> int:
    sys.stdout.reconfigure(line_buffering=True)  # progress survives a kill
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a CUDA card")
    if not (ROOT / "src" / "repro_torch").is_dir() or not REF.exists():
        fail("src/repro_torch or the JAX reference results are missing "
             "beside chip_smoke.py")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    print(f"card: {card_line()}")
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(built)}")
    for name, (secs, output) in built.items():
        info = [ln.strip() for ln in output.splitlines() if "ptxas info" in ln]
        print(f"  {name}: {secs:.2f} s; " + " | ".join(info))

    modes = check_kernels(torch, dev)
    launches = run_slice(torch, dev)

    main_mode = next(m for m in modes if (m["mode"], m["bits"]) == ("affine", 8))
    print(json.dumps({"kernels": [dict(
        name="fake_quant", route="cuda",
        source="src/repro_torch/csrc/fake_quant.cu",
        replaces="src/repro/kernels/fake_quant/fake_quant.py:45",
        launches=launches, max_abs_err=max(m["max_abs_err"] for m in modes),
        ms=main_mode["ms"], kernel_ms=main_mode["ms"], plain_ms=main_mode["plain_ms"],
        bound_ms=main_mode["bound_ms"], bound_by="bytes",
        library_ms=main_mode["library_ms"], modes=modes)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
