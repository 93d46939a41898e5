#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

  python3 chip_smoke.py

1. device: requires CUDA; prints the card's name and power limit;
2. build: compiles every CUDA source of the port with nvcc (in parallel);
3. kernel vs plain: ``fake_quant`` (affine at 4/8/16 bits, pow2) in
   float32 and bfloat16 on the 15 VGG-16/CIFAR-10 weight shapes, two
   ragged ones, a prefill's activations with one scale for the tensor
   and a view off a 16-byte boundary, launched per tensor and as one
   group, held to its plain torch version on the same tensors (0
   differing elements, and within 1e-6), and timed (grouped, per weight,
   with the L2 flushed) beside the plain version,
   ``torch.fake_quantize_per_channel_affine`` and the memory bound; then
   the shapes phase 7 gives it, one by one and as one group, at 0
   differing elements: SmolLM-135M's projection weights and tied head
   (576 x 49152) in float32 with a scale a column, and its decode and
   prefill activations with one scale, in both types;
4. the slice: the quickstart loop at full size on the card (27,000-point
   paper grid, VGG-16/CIFAR-10, oracle and surrogate DSE, Pareto, report,
   best LightPE-1 design, every preset's fake quantization of VGG-16's
   weights), with kernel launches counted over that run (exactly 5: one
   grouped launch a quantizing preset, two for LightPE-2) and the results
   held to ``tests/data/torch_quickstart_ref.json`` (the JAX package's);
   then a 2^20-point subsample of WIDE_SPACE in 65,536-point chunks;
5. kernel vs plain, slice 2: ``quant_matmul`` (int4, pow2, int8; float32
   and bfloat16 x) at SmolLM-135M's projection shapes for decode (M = 4)
   and prefill (M = 4 * 130), at M = 1, 16, 17 and 64 (the edges of the
   GEMV and tensor-core variants), three ragged shapes and a layer view
   off a 16-byte boundary, held to its plain version within rtol 1e-5 /
   atol 1e-4, and two calls held to the same bits; ``flash_attention`` (GQA 9/3,
   head_dim 64) at the prefill shape and at decode (Sq 1 and 2) at offsets
   0, 1, 63, 135 and 255 (across the cluster's split boundaries), with
   float32 q and the float32 cache (the served path) and bfloat16 q on
   the same cache, round_p on and off, and three ragged shapes, within
   2e-5, two calls held to the same bits; each kernel timed beside its
   plain version, a library call and its bound (``flash_attention`` at
   the served types and with bfloat16 q);
6. the slice of serving: SmolLM-135M at full width (numpy-drawn weights),
   packed as LightPE-1 and as INT8 and served in bfloat16 and float32 by
   ``ServeEngine`` (4 prompts of 8-130 tokens in 4 slots, 12 new tokens
   each; then 6 requests in 4 slots), with the launches of the 4 x 12 run
   counted (exactly 2,520 ``quant_matmul`` and 360 ``flash_attention``) and
   every run held to ``tests/data/torch_serve_ref.json`` (the JAX
   package's); then prefill and decode times, tokens/s and peak memory;
7. the slice of QAT numerics: SmolLM-135M at full width on its dense
   weights under INT16, LightPE-1, LightPE-2 and INT8 numerics in
   bfloat16 and LightPE-1 in float32 (``fake_quant`` on every weight and
   every activation, bfloat16 activations included), served by
   ``ServeEngine`` (the 4 prompts in 4 slots, 12 new tokens each), with
   ``fake_quant`` launches counted per run (exactly 12 steps x (30 x 7
   projections + the head) x 2 passes, weight and activation; 3 for
   LightPE-2, whose weights take two) and every run held to the
   ``qat_modes`` of ``tests/data/torch_serve_ref.json``, with the steps
   compared and the tolerated near ties recorded; as a control, the
   bfloat16 LightPE-1 run held to the float32 LightPE-1 reference must
   fail that comparison;
8. the slice of joint co-exploration (no kernel of its own: the
   evaluator is eager torch): ``coexplore_front`` over the 13-model
   ``default_model_set`` x the 27,000-point paper grid (351,000 joint
   points, oracle) with mixed-model lanes, held to
   ``tests/data/torch_coexplore_ref.json`` (the JAX package's front as
   an index set up to near ties, objectives at 1e-5, front counts, layer
   buckets, per-(model, PE) bests and the LightPE claim for every
   model); the same walk per model, bitwise equal; under
   ``Budget(area_mm2=0.9)`` two-stage and single-stage, bitwise equal to
   each other and held to the reference's counts and front; 4,500
   points under ``Budget(area_mm2=2.0, power_mw=250.0)`` held to the
   reference; and 4,500 points under phase 4's fitted surrogate, mixed
   and per model, bitwise equal; each walk's wall time and points/s;
9. DSE at scale (``core/shard``, ``core/search``, ``serve/frontserver``,
   ``obs``; no kernel of its own but the serving run's): the 351,000-point
   joint walk sharded 4 ways with 2 chunks a shard in flight (a CUDA
   stream a shard) and a ``Tracer``, bitwise equal to phase 8's walk
   (front, bests, claim), with 4 shard lanes in its Chrome trace and its
   ``SweepReport`` phases within its wall time; the same sharded under
   ``Budget(area_mm2=0.9)``; killed after 40 chunks and resumed from its
   checkpoint, bitwise equal, and a wrong signature refused; 2^20 points
   of WIDE_SPACE sharded 4 ways with the front streamed to CSV, bitwise
   equal to the unsharded walk; ``search_front`` (evolve, halving) at
   40,000 evaluations over 3 models x ``MAPPED_SPACE``, shards 1 and 4
   bitwise equal, held to ``tests/data/torch_scale_ref.json`` generation
   by generation up to the first near tie, with ``hv_ratio`` and
   coverage against the ``REF_SPACE`` front (itself held to the
   reference's); the 12-query
   storm on one ``FrontServer`` walk held to the same file, queries 1
   and 3 bitwise equal to standalone walks, a repeat and a restored
   cache answering with 0 chunk evaluations; and phase 6's LightPE-1
   run with telemetry on, bitwise equal to the run with it off, with the
   launches and ``serve.*`` counts; each step's wall time and points/s;
10. prints a ``{"kernels": [...]}`` line and, last, the device line.

TF32 is off for matrix products and convolutions (``repro_torch`` sets
both flags at import): the reference tolerances need IEEE float32.

Any failed phase exits non-zero before the last line is printed.
"""

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
REF = ROOT / "tests" / "data" / "torch_quickstart_ref.json"
SERVE_REF = ROOT / "tests" / "data" / "torch_serve_ref.json"
COEX_REF = ROOT / "tests" / "data" / "torch_coexplore_ref.json"
SCALE_REF = ROOT / "tests" / "data" / "torch_scale_ref.json"
SCALE_SHARDS = 4
SCALE_DEPTH = 2
KILL_AFTER = 40

# (R*S*C, K) of VGG-16/CIFAR-10's 15 layers, and two ragged shapes.
VGG16_SHAPES = [(27, 64), (576, 64), (576, 128), (1152, 128), (1152, 256),
                (2304, 256), (2304, 256), (2304, 512)] + [(4608, 512)] * 5 \
    + [(512, 512), (512, 10)]
RAGGED_SHAPES = [(300, 190), (1, 129)]
ACT_SHAPE = (4 * 130, 576)      # a prefill's activations, one scale
UNALIGNED = (190, 33)           # a view one element off 16 bytes
KERNEL_MODES = [("affine", 4), ("affine", 8), ("affine", 16), ("pow2", 8)]
KERNEL_TOL = 1e-6
H100_BYTES_PER_S = 3.35e12      # HBM3 of the H100 SXM (NVIDIA data sheet)
H100_F32_FLOPS = 67e12          # float32 outside the tensor cores (same)
H100_BF16_FLOPS = 989e12        # bf16 tensor cores, dense (same)
SLEEP_CYCLES = 200_000_000      # ~0.1 s at the H100's ~1.98 GHz clock
WIDE_POINTS = 2 ** 20
WIDE_CHUNK = 65536

# Slice 2.  SmolLM-135M's projections (K, N): wq/wo, wk/wv, w_up/w_gate,
# w_down (each checked with float32 and bfloat16 x: the residual stream
# is bfloat16, the MLP's hidden float32); ragged shapes of the
# reference's kernel test.
QMM_SHAPES = [(576, 576), (576, 192), (576, 1536), (1536, 576)]
QMM_RAGGED = [(37, 300, 190), (1, 512, 129), (200, 254, 64)]
QMM_EDGE_M = (1, 16, 17, 64)
PROJECTIONS = ("wq", "wk", "wv", "wo", "w_up", "w_gate", "w_down")
QMM_MODES = ("int4", "pow2", "int8")
QMM_RTOL, QMM_ATOL = 1e-5, 1e-4         # tests/test_kernels.py:45
FA_TOL = 2e-5                           # tests/test_kernels.py:122
FA_DECODE_OFFSETS = (0, 1, 63, 135, 255)   # across the split boundaries
FA_DECODE_SQ = (1, 2)                       # the decode plan's Sq at G = 3
# (q type, K/V type, round_p): the served float32 path, and bfloat16 q
# with the engine's float32 cache (the model without packed weights)
FA_PATH_TYPES = [("float32", "float32", False), ("float32", "float32", True),
                 ("bfloat16", "float32", False), ("bfloat16", "float32", True)]
FA_RAGGED = [(100, 100, 32), (64, 256, 16), (1, 128, 64)]
# Logit tolerances of the serving runs against the JAX package (on the
# CPU the port is 0.033 / 0.026 from it in bfloat16, 2.8e-4 / 3.3e-6 in
# float32; bfloat16 rounding turns the order of float32 sums into ~0.04
# over 30 layers, and in float32 LightPE-1 also carries the few pow2 codes
# that sit at a log2 tie, which INT8 has none of).
SERVE_TOL = {"lightpe1": 0.1, "int8": 0.1, "lightpe1/float32": 2e-3,
             "int8/float32": 1e-4}
SERVE_LAUNCHES = {"quant_matmul": 12 * 30 * 7, "flash_attention": 12 * 30}
QUICKSTART_LAUNCHES = 5         # int16 1, lightpe1 1, lightpe2 2, int8 1
# Slice 5: the model on dense weights under QAT numerics, held to the JAX
# package's runs (``qat_modes`` of the serving reference), the comparison
# coupled across the batch (one activation scale for the whole batch).
# In bfloat16 the runs take the serving runs' 0.1.  In float32 LightPE-1
# cannot take their 2e-3: with 8-bit activations a code at a round(x / s)
# tie flips by one step of absmax / 127 when a float32 sum is taken in
# another order, and 30 layers carry it on; one float32 ulp on half the
# embedded tokens moves the card's LightPE-1 logits by up to 0.100
# (benchmarks/torch_qat_sensitivity.py).  So 0.125: above that, and below
# what the bfloat16 LightPE-1 run reads against the float32 reference
# (QAT_CONTROL, which must fail), so the limit still tells the two
# compute types apart.
QAT_TOL = {"int16": 0.1, "lightpe1": 0.1, "lightpe2": 0.1, "int8": 0.1,
           "lightpe1/float32": 0.125}
# fake_quant launches a projection a step: the weight and the activation
# (LightPE-2's weight takes two passes); 7 projections a layer and the head
QAT_PASSES = {"int16": 2, "lightpe1": 2, "lightpe2": 3, "int8": 2}
QAT_PROJECTIONS = 7
# the control: a run in the wrong compute type, held to the float32 run
QAT_CONTROL = ("lightpe1", "lightpe1/float32")
# Phase 3 at the shapes of phase 7 (SmolLM-135M): the projection weights
# and the tied head, float32, a scale a column; the activations of decode
# (4 rows) and prefill (4 x 130 rows), one scale, in both types.  1536 and
# 49152 columns pass a block's vector stride (1024 float32 elements), so
# the column counter wraps within a thread.
SMOLLM_WEIGHTS = [(576, 576), (576, 192), (576, 1536), (1536, 576),
                  (576, 49152)]
SMOLLM_ACTS = [(4, 576), (4, 1536), (520, 576), (520, 1536)]


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


def cold_ms(torch, fn, flush, reps: int = 5):
    """Mean device milliseconds of ``fn()`` with the L2 cache flushed
    before each call (``flush`` is a buffer larger than the 50 MB L2,
    zeroed between the calls): sleep, flush, start, fn, end, queued so the
    events see the device only."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES // 10)
        flush.zero_()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def check_kernels(torch, dev):
    """Phase 3: fake_quant against its plain version, per tensor and in
    one grouped launch, in float32 and bfloat16, and its times."""
    from repro_torch.kernels.fake_quant import fake_quant, fake_quant_group
    from repro_torch.kernels.fake_quant.ref import (ref_fake_quant_affine,
                                                    ref_fake_quant_pow2)
    from repro_torch.quant.fake_quant import affine_scale, pow2_emax
    from repro_torch.quickstart import draw_weights

    base = draw_weights(VGG16_SHAPES + RAGGED_SHAPES + [ACT_SHAPE], seed=1,
                        device=dev)
    base[-1] = base[-1] * 30                       # activations: N(0, 3^2)
    flat = draw_weights([(UNALIGNED[0] * UNALIGNED[1] + 1,)], seed=2,
                        device=dev)[0]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    n_vgg = len(VGG16_SHAPES)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        ws = [w.to(dtype) for w in base]
        # a view one element off a 16-byte boundary (a scalar head)
        ws.append(flat.to(dtype)[1:].view(UNALIGNED))
        if ws[-1].data_ptr() % 16 == 0:
            fail("the view meant to be unaligned is aligned")
        vgg = ws[:n_vgg]
        elem = vgg[0].element_size()
        nbytes = sum(w.numel() * 2 * elem + w.shape[1] * elem for w in vgg)
        # divide, round, two compares, multiply an element
        bound, bound_by = bound_ms(nbytes, 5 * sum(w.numel() for w in vgg))
        for mode, bits in KERNEL_MODES:
            def scale(w, per_tensor):
                axis = None if per_tensor else 0
                s = (affine_scale(w, bits, axis) if mode == "affine"
                     else pow2_emax(w, axis))
                return s.reshape(1) if per_tensor else s[0]

            def plain(w, s):
                return (ref_fake_quant_affine(w, s, bits) if mode == "affine"
                        else ref_fake_quant_pow2(w, s))

            # the activations take one scale for the whole tensor, as in
            # the model; every other tensor one a column
            scales = [scale(w, per_tensor=(i == len(base) - 1))
                      for i, w in enumerate(ws)]
            before = fake_quant.launches
            single = [fake_quant(w, s, mode=mode, bits=bits)
                      for w, s in zip(ws, scales)]
            grouped = fake_quant_group(ws, scales, mode=mode, bits=bits)
            if fake_quant.launches - before != len(ws) + 1:
                fail(f"fake_quant {name} {mode}{bits}: "
                     f"{fake_quant.launches - before} launches, expected "
                     f"{len(ws) + 1}")
            want = [plain(w, s) for w, s in zip(ws, scales)]
            torch.cuda.synchronize()
            err, differing = 0.0, 0
            for got in (single, grouped):
                for g, w in zip(got, want):
                    if g.shape != w.shape or not bool(torch.isfinite(g).all()):
                        fail(f"fake_quant {name} {mode}{bits}: bad output "
                             f"{tuple(g.shape)}")
                    differing += int((g != w).sum())
                    err = max(err, float((g.float() - w.float()).abs().max()))
            if differing or err > KERNEL_TOL:
                fail(f"fake_quant {name} {mode}{bits}: {differing} elements "
                     f"differ from plain, max abs err {err} (tolerance "
                     f"{KERNEL_TOL})")
            pairs = list(zip(vgg, scales[:n_vgg]))
            group_fn = lambda: fake_quant_group(  # noqa: E731
                vgg, scales[:n_vgg], mode=mode, bits=bits)
            each_fn = lambda: [fake_quant(w, s, mode=mode, bits=bits)  # noqa: E731
                               for w, s in pairs]
            row = dict(
                dtype=name, mode=mode, bits=bits, differing=differing,
                max_abs_err=err, ms=time_ms(torch, group_fn),
                cold_ms=cold_ms(torch, group_fn, flush),
                per_weight_ms=time_ms(torch, each_fn),
                host_paced_ms=time_ms(torch, group_fn, queued=False),
                plain_ms=time_ms(torch, lambda: [plain(w, s)
                                                 for w, s in pairs]),
                library_ms=None, bound_ms=bound, bound_by=bound_by,
                bytes=nbytes)
            if mode == "affine" and dtype == torch.float32:
                qmax = 2 ** (bits - 1) - 1
                zps = [torch.zeros(w.shape[1], dtype=torch.int32, device=dev)
                       for w in vgg]
                row["library_ms"] = time_ms(torch, lambda: [
                    torch.fake_quantize_per_channel_affine(w, s, z, 1, -qmax,
                                                           qmax)
                    for (w, s), z in zip(pairs, zps)])
            rows[(name, mode, bits)] = row
            print(f"fake_quant {name} {mode}{bits}: {differing} differing, "
                  f"max_abs_err={err}; 15 VGG-16 weights: grouped "
                  f"{row['ms']:.4f} ms (L2 flushed {row['cold_ms']:.4f}, "
                  f"host-paced {row['host_paced_ms']:.4f}), per weight "
                  f"{row['per_weight_ms']:.4f} ms, plain {row['plain_ms']:.4f}"
                  f" ms, library {row['library_ms']} ms, bound "
                  f"{bound:.4f} ms ({nbytes} bytes)")
    return rows


def check_model_shapes(torch, dev):
    """Phase 3 at SmolLM-135M's QAT shapes: each tensor alone and all in
    one group, 0 differing elements from the plain version; returns the
    count of elements compared."""
    from repro_torch.kernels.fake_quant import fake_quant, fake_quant_group
    from repro_torch.kernels.fake_quant.ref import (ref_fake_quant_affine,
                                                    ref_fake_quant_pow2)
    from repro_torch.quant.fake_quant import affine_scale, pow2_emax
    from repro_torch.quickstart import draw_weights

    weights = draw_weights(SMOLLM_WEIGHTS, seed=3, device=dev)
    acts = [a * 30 for a in draw_weights(SMOLLM_ACTS, seed=4, device=dev)]
    compared = 0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        ts = (weights if dtype == torch.float32 else []) + [
            a.to(dtype) for a in acts]
        per_tensor = [False] * (len(ts) - len(acts)) + [True] * len(acts)
        for mode, bits in KERNEL_MODES:
            def scale(t, one):
                axis = None if one else 0
                s = (affine_scale(t, bits, axis) if mode == "affine"
                     else pow2_emax(t, axis))
                return s.reshape(1) if one else s[0]

            scales = [scale(t, one) for t, one in zip(ts, per_tensor)]
            single = [fake_quant(t, s, mode=mode, bits=bits)
                      for t, s in zip(ts, scales)]
            grouped = fake_quant_group(ts, scales, mode=mode, bits=bits)
            for t, s, a, b in zip(ts, scales, single, grouped):
                want = (ref_fake_quant_affine(t, s, bits) if mode == "affine"
                        else ref_fake_quant_pow2(t, s))
                for how, got in (("alone", a), ("grouped", b)):
                    differing = int((got != want).sum())
                    if got.shape != want.shape or differing:
                        fail(f"fake_quant {name} {mode}{bits} at "
                             f"{tuple(t.shape)} ({how}): {differing} "
                             f"elements differ from plain")
                    compared += want.numel()
    print(f"fake_quant at SmolLM-135M's shapes (weights {SMOLLM_WEIGHTS} "
          f"float32, activations {SMOLLM_ACTS} float32 and bfloat16, "
          f"{len(KERNEL_MODES)} modes, alone and grouped): 0 of {compared} "
          f"elements differ from plain")
    return compared


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
    if launches != QUICKSTART_LAUNCHES:
        fail(f"the quickstart loop launched fake_quant {launches} times, "
             f"expected {QUICKSTART_LAUNCHES} (one grouped launch a "
             f"quantizing preset, two for LightPE-2)")

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
    return launches, warm.models


def device_ms(torch, chunks, reps: int = 5, sleep: int = SLEEP_CYCLES // 10):
    """Mean device milliseconds of calling every function in ``chunks``
    once.  Each chunk (a few hundred launches at most, within what the
    stream queues) is queued behind a short sleep kernel, so its events
    time the device's work back to back, without the gaps of a host
    slower than the device; the chunks' times are summed."""
    for fn in chunks:
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        for fn in chunks:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(sleep)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
    return total / reps


def bound_ms(nbytes: float, flops: float, peak: float = H100_F32_FLOPS):
    """(least milliseconds, what bounds it) at the H100 SXM's HBM rate and
    ``peak`` operations a second (default: the float32 CUDA-core rate)."""
    by_bytes = nbytes / H100_BYTES_PER_S * 1e3
    by_ops = flops / peak * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def ptxas_summary(output: str) -> str:
    """Kernels, register range and spills from nvcc's ``-Xptxas -v``."""
    import re
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", output)]
    spills = sum(int(a) + int(b) for a, b in re.findall(
        r"(\d+) bytes spill stores, (\d+) bytes spill loads", output))
    if not regs:
        return "no ptxas report"
    return (f"{len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
            f"{spills} bytes of spills")


def check_serving_kernels(torch, dev):
    """Phase 5: quant_matmul and flash_attention against their plain
    versions on the same tensors on the card."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bh,
                                                     flash_attention_gqa)
    from repro_torch.kernels.flash_attention import plan as fa_plan
    from repro_torch.kernels.flash_attention.ref import (ref_attention_gqa,
                                                         ref_flash_attention)
    from repro_torch.kernels.quant_matmul import launch_plan, quant_matmul
    from repro_torch.kernels.quant_matmul.ref import ref_quant_matmul
    from repro_torch.quant.pack import QUANTIZE
    from repro_torch.serve.check import BATCH_SLOTS, MAX_LEN, PROMPT_LENS

    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    prefill_m = BATCH_SLOTS * max(PROMPT_LENS)
    cases = [(m, k, n) for k, n in QMM_SHAPES
             for m in (BATCH_SLOTS, prefill_m) + QMM_EDGE_M] + QMM_RAGGED
    qmm_err, variants = 0.0, set()

    def held(name, x, codes, scale, mode):
        nonlocal qmm_err
        got = quant_matmul(x, codes, scale, mode=mode)
        again = quant_matmul(x, codes, scale, mode=mode)
        want = ref_quant_matmul(x, codes, scale, mode)
        torch.cuda.synchronize()
        variants.add(launch_plan(x, codes, mode).variant)
        if got.shape != want.shape or not bool(torch.isfinite(got).all()):
            fail(f"quant_matmul {name}: bad output")
        if not torch.allclose(got, want, rtol=QMM_RTOL, atol=QMM_ATOL):
            fail(f"quant_matmul {name}: differs from plain by "
                 f"{float((got - want).abs().max())}")
        if not torch.equal(got, again):
            fail(f"quant_matmul {name}: two calls differ")
        qmm_err = max(qmm_err, float((got - want).abs().max()))

    for m, k, n in cases:
        w = randn(k, n) * 0.08
        for mode in QMM_MODES:
            codes, scale = QUANTIZE[mode](w)
            for x_type in (torch.float32, torch.bfloat16):
                held(f"{mode} {x_type} {(m, k, n)}", randn(m, k).to(x_type),
                     codes, scale, mode)
    # a layer's view into stacked codes, 8 bytes off a 16-byte boundary
    stack, stack_scale = QUANTIZE["pow2"](randn(2, 574, 72) * 0.08)
    if stack[1].data_ptr() % 16 == 0:
        fail("the layer view meant to be unaligned is aligned")
    for m in (BATCH_SLOTS, prefill_m):
        held(f"pow2 layer view M={m}", randn(m, 574), stack[1], stack_scale[1],
             "pow2")
    print(f"quant_matmul vs plain: {len(cases)} shapes x {len(QMM_MODES)} "
          f"modes x 2 x types and an unaligned layer view, variants "
          f"{sorted(variants)}, max_abs_err={qmm_err} (tolerance rtol "
          f"{QMM_RTOL} / atol {QMM_ATOL}); two calls bitwise equal")

    fa_err = 0.0

    def held(name, got, want):
        nonlocal fa_err
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        if not bool(torch.isfinite(got).all()) or err > FA_TOL:
            fail(f"flash_attention {name}: differs from plain by {err}")
        fa_err = max(fa_err, err)

    b, hq, hkv, d = BATCH_SLOTS, 9, 3, 64
    fa_cases = [(max(PROMPT_LENS), 0)] + [
        (sq, min(o, MAX_LEN - sq)) for sq in FA_DECODE_SQ
        for o in FA_DECODE_OFFSETS]
    plans = set()
    for q_name, kv_name, round_p in FA_PATH_TYPES:
        q_type, kv_type = getattr(torch, q_name), getattr(torch, kv_name)
        for sq, off in fa_cases:
            q = randn(b, sq, hq, d).to(q_type)
            k, v = (randn(b, MAX_LEN, hkv, d).to(kv_type) for _ in range(2))
            start = torch.full((b,), off, dtype=torch.int32, device=dev)
            name = f"gqa {q_name} q, {kv_name} K/V, round_p={round_p}, " \
                   f"Sq={sq} offset={off}"
            got = flash_attention_gqa(q, k, v, start, round_p=round_p)
            again = flash_attention_gqa(q, k, v, start, round_p=round_p)
            held(name, got, ref_attention_gqa(q, k, v, start,
                                              round_p=round_p))
            if not torch.equal(got, again):
                fail(f"flash_attention {name}: two calls differ")
            plans.add(fa_plan(b, sq, MAX_LEN, hq, hkv, d,
                              q_type == torch.bfloat16).variant)
    for sq, skv, dh in FA_RAGGED:
        q, k, v = randn(2, 2, sq, dh), randn(2, 2, skv, dh), randn(2, 2, skv, dh)
        got = flash_attention_bh(q, k, v)
        want = torch.stack([torch.stack([ref_flash_attention(q[i, j], k[i, j],
                                                             v[i, j])
                                         for j in range(2)]) for i in range(2)])
        held(f"bh {(sq, skv, dh)}", got, want)
    q, k, v = randn(128, 32), randn(128, 32), randn(128, 32)
    held("non-causal", flash_attention(q, k, v, causal=False),
         ref_flash_attention(q, k, v, causal=False))
    qb, kb, vb = (t.to(torch.bfloat16) for t in (q, k, v))
    held("bfloat16", flash_attention(qb, kb, vb),
         ref_flash_attention(qb, kb, vb))
    print(f"flash_attention vs plain: prefill, decode (Sq {FA_DECODE_SQ}) at "
          f"offsets {FA_DECODE_OFFSETS}, GQA {hq}/{hkv}, types "
          f"{FA_PATH_TYPES}, variants {sorted(plans)}; ragged, non-causal, "
          f"bf16: max_abs_err={fa_err} (tolerance {FA_TOL}); two calls "
          f"bitwise equal")
    return qmm_err, fa_err


def time_serving_kernels(torch, dev, cfg, packed, index):
    """The two kernels' device times for one step of the served model
    (its own LightPE-1 codes, all 30 layers) beside their plain versions,
    a library call and the bound; ``flash_attention`` with the served
    float32 q and again with bfloat16 q, on the float32 cache.  Decode:
    M = 4 rows against a cache filled to ``index``; prefill: M = 4 * 130
    rows from position 0.
    Each bound is the bytes or the bf16 tensor rate (a float32 operand
    as three exact bf16 parts), the float32 CUDA-core bound of the
    kernels' first versions beside it; ``quant_matmul``'s decode step is
    also timed per projection."""
    from repro_torch.kernels.flash_attention import flash_attention_gqa
    from repro_torch.kernels.flash_attention import plan as fa_plan
    from repro_torch.kernels.flash_attention.ref import ref_attention_gqa
    from repro_torch.kernels.quant_matmul import launch_plan, quant_matmul
    from repro_torch.kernels.quant_matmul.ref import ref_quant_matmul
    from repro_torch.quant.pack import dequantize_pow2
    from repro_torch.serve.check import BATCH_SLOTS, MAX_LEN, PROMPT_LENS

    sdpa = torch.nn.functional.scaled_dot_product_attention
    gen = torch.Generator(device=dev).manual_seed(4)
    lay = packed["layers"]
    # (packed leaf, the x type it takes on the path)
    projections = [(lay["attn"][n], torch.bfloat16) for n in
                   ("wq", "wk", "wv", "wo")] + [
        (lay["mlp"]["w_up"], torch.bfloat16),
        (lay["mlp"]["w_gate"], torch.bfloat16),
        (lay["mlp"]["w_down"], torch.float32)]
    qmm, fa = {}, {}
    s_prefill = max(PROMPT_LENS)
    for phase, m in (("decode", BATCH_SLOTS), ("prefill", BATCH_SLOTS * s_prefill)):
        calls, nbytes, flops, tc_flops = [], 0, 0, 0
        for i in range(cfg.n_layers):
            for leaf, x_type in projections:
                codes, scale = leaf["codes__pow2"][i], leaf["scale"][i]
                k, n = codes.shape[0] * 2, codes.shape[1]
                x = torch.randn((m, k), generator=gen, device=dev).to(x_type)
                calls.append((x, codes, scale))
                nbytes += (codes.numel() + scale.numel() * 4
                           + x.numel() * x.element_size() + m * n * 4)
                flops += 2 * m * k * n
                tc_flops += 2 * m * k * n * (3 if x_type == torch.float32
                                             else 1)
        dense = [(x.float(), dequantize_pow2(c, s)) for x, c, s in calls]
        kernel_ms = device_ms(torch, [lambda: [
            quant_matmul(x, c, s, mode="pow2") for x, c, s in calls]])
        per_projection = None
        if phase == "decode":   # calls are layer-major: projection j at j::7
            per_projection = {name: device_ms(torch, [lambda j=j: [
                quant_matmul(x, c, s, mode="pow2")
                for x, c, s in calls[j::len(projections)]]])
                for j, name in enumerate(PROJECTIONS)}
        plain_ms = device_ms(torch, [
            (lambda part=calls[j:j + 21]: [ref_quant_matmul(x, c, s, "pow2")
                                           for x, c, s in part])
            for j in range(0, len(calls), 21)])
        library_ms = device_ms(torch, [lambda: [torch.matmul(x, w)
                                                for x, w in dense]])
        bound, by = bound_ms(nbytes, tc_flops, H100_BF16_FLOPS)
        bound_f32 = bound_ms(nbytes, flops)[0]
        variant = sorted({launch_plan(x, c, "pow2").variant
                          for x, c, _ in calls})
        qmm[phase] = dict(ms=kernel_ms, plain_ms=plain_ms,
                          library_ms=library_ms, bound_ms=bound, bound_by=by,
                          bound_f32_ms=bound_f32, launches=len(calls),
                          bytes=nbytes, flops=flops, tc_flops=tc_flops,
                          variant="/".join(variant),
                          per_projection_ms=per_projection)
        del dense

    b, hq, hkv, d = BATCH_SLOTS, cfg.n_heads, cfg.kv_heads, cfg.head_dim
    # "float32": the served path (packed weights give float32 q, and the
    # engine's cache is float32); "bf16_q": bfloat16 q on the same cache
    # (the model on bfloat16 weights)
    fa_bf16 = {}
    for q_name, rows in (("float32", fa), ("bfloat16", fa_bf16)):
        q_type = getattr(torch, q_name)
        for phase, sq, start in (("decode", 1, index),
                                 ("prefill", s_prefill, 0)):
            q = torch.randn((cfg.n_layers, b, sq, hq, d), generator=gen,
                            device=dev).to(q_type)
            kv = torch.randn((2, cfg.n_layers, b, MAX_LEN, hkv, d),
                             generator=gen, device=dev)
            st = torch.full((b,), start, dtype=torch.int32, device=dev)
            qpos = start + torch.arange(sq, device=dev)
            mask = torch.arange(MAX_LEN, device=dev)[None, :] <= qpos[:, None]
            kernel_ms = device_ms(torch, [lambda: [
                flash_attention_gqa(q[i], kv[0, i], kv[1, i], st,
                                    round_p=True)
                for i in range(cfg.n_layers)]])
            plain_ms = device_ms(torch, [lambda: [
                ref_attention_gqa(q[i], kv[0, i], kv[1, i], st, round_p=True)
                for i in range(cfg.n_layers)]])
            library_ms = None
            if q_type == torch.float32:   # one call of the same function
                # SDPA's layout (B, H, S, D), made before the timing
                tq, tk, tv = (t.transpose(-2, -3).contiguous()
                              for t in (q, kv[0], kv[1]))
                library_ms = device_ms(torch, [lambda: [
                    sdpa(tq[i], tk[i], tv[i], attn_mask=mask,
                         enable_gqa=True) for i in range(cfg.n_layers)]])
            # what this run needs: q and out once, the keys up to the last
            # query's position (the kernel skips the rest), 2 D-long dot
            # products per visible (query, key) pair.  On the bf16 tensor
            # rate, as quant_matmul's bound: q . k is one pass for bfloat16
            # q (K rounded to it) and 9 for float32 q and K (three exact
            # bf16 parts each); P V on the float32 cache is 9 (P rounded to
            # float32 is P).  The float32 CUDA-core bound stands beside it.
            keys = min(MAX_LEN, start + sq)
            visible = sum(min(MAX_LEN, start + i + 1) for i in range(sq))
            per_layer_bytes = (b * sq * hq * d * (q.element_size() + 4)
                               + 2 * 4 * b * keys * hkv * d)
            nbytes = cfg.n_layers * per_layer_bytes
            half = cfg.n_layers * 2 * b * hq * d * visible
            qk_passes = 1 if q_type == torch.bfloat16 else 9
            bound, by = bound_ms(nbytes, half * (qk_passes + 9),
                                 H100_BF16_FLOPS)
            qk_peak = (H100_BF16_FLOPS if q_type == torch.bfloat16
                       else H100_F32_FLOPS)
            bound_f32 = bound_ms(nbytes, half * H100_F32_FLOPS / qk_peak
                                 + half)[0]
            rows[phase] = dict(
                ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound, bound_by=by, bound_f32_ms=bound_f32,
                launches=cfg.n_layers,
                start=start, q_rows=sq, q_type=q_name, kv_type="float32",
                variant=fa_plan(b, sq, MAX_LEN, hq, hkv, d,
                                q_type == torch.bfloat16).variant)
    for name, rows in (("quant_matmul", qmm), ("flash_attention", fa),
                       ("flash_attention bf16 q", fa_bf16)):
        for phase, r in rows.items():
            extra = (f"; {r['variant']}, float32 CUDA-core bound "
                     f"{r['bound_f32_ms']:.4f} ms")
            if name != "quant_matmul":
                extra += f", q {r['q_type']}, K/V {r['kv_type']}"
            print(f"{name} {phase} step ({r['launches']} launches): kernel "
                  f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library "
                  f"{r['library_ms']} ms, bound {r['bound_ms']:.4f} ms "
                  f"({r['bound_by']}){extra}")
    print("quant_matmul decode step per projection (30 launches each): "
          + ", ".join(f"{k} {v:.4f} ms"
                      for k, v in qmm["decode"]["per_projection_ms"].items()))
    fa["bf16_q"] = fa_bf16
    return qmm, fa


def run_serving(torch, dev):
    """Phase 6: SmolLM-135M served on packed weights at full width, held
    to the JAX package's runs; returns the launch counts of the LightPE-1
    4 x 12 run, the kernel times and the step numbers."""
    import numpy as np
    from repro_torch import convert
    from repro_torch.configs import get
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.quant_matmul import quant_matmul
    from repro_torch.models import family_module
    from repro_torch.serve import (ServeEngine, check, packed_bytes,
                                   quantize_params)

    ref = json.loads(SERVE_REF.read_text())
    cfg = get(ref["config"])
    mod = family_module(cfg)
    t0 = time.perf_counter()
    params = convert.params_from_numpy(mod.numpy_params(cfg, ref["param_seed"]),
                                       dev)
    packs = {pe: quantize_params(params, pe, min_size=ref["min_size"])
             for pe in sorted({m["pe_type"] for m in ref["modes"].values()})}
    torch.cuda.synchronize()
    print(f"serving: {cfg.name} at full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads}/{cfg.kv_heads} heads, vocab "
          f"{cfg.vocab}); weights drawn and packed in "
          f"{time.perf_counter() - t0:.2f} s; dense {ref['dense_bytes']} B")

    def to_numpy(t):
        return t.float().cpu().numpy()

    prompts = [np.array(p) for p in ref["prompts"]]
    reuse = [np.array(p) for p in ref["reuse_prompts"]]
    launches = None
    for key, m in ref["modes"].items():
        packed = packs[m["pe_type"]]
        if packed_bytes(packed) != m["packed_bytes"]:
            fail(f"{key}: packed_bytes {packed_bytes(packed)} != the JAX "
                 f"package's {m['packed_bytes']}")
        run_cfg = cfg.replace(dtype=m["dtype"])

        def engine():
            return ServeEngine(run_cfg, mod, packed, ref["batch_slots"],
                               ref["max_len"])

        quant_matmul.launches = 0
        flash_attention.launches = 0
        got = check.record(engine(), prompts, ref["max_new"], to_numpy)
        counts = {"quant_matmul": quant_matmul.launches,
                  "flash_attention": flash_attention.launches}
        if counts != SERVE_LAUNCHES:
            fail(f"{key}: launches {counts} on the 4 x {ref['max_new']} run, "
                 f"expected {SERVE_LAUNCHES}")
        if key == "lightpe1":
            launches = counts
        runs = [("run4", got)]
        if "run6" in m:
            runs.append(("run6", check.record(engine(), reuse,
                                              ref["reuse_max_new"], to_numpy)))
        for name, rec in runs:
            problems, notes = check.compare(rec, m[name], SERVE_TOL[key])
            for note in notes:
                print(f"  tolerated ({key} {name}): {note}")
            if problems:
                fail(f"{key} {name} differs from the JAX reference: "
                     + "; ".join(problems))
            print(f"{key} {name}: matches the JAX reference (max logit err "
                  f"{check.max_logit_err(rec, m[name]):.3g}, tolerance "
                  f"{SERVE_TOL[key]}); tokens of request 0: {rec['tokens'][0]}")
    if launches is None:
        fail("the reference has no lightpe1 run")
    print(f"launches on the LightPE-1 4 x {ref['max_new']} run: {launches}")

    # the served default (LightPE-1 codes, bfloat16), warm, timed per step
    eng = ServeEngine(cfg, mod, packs["lightpe1"], ref["batch_slots"],
                      ref["max_len"])
    steps = {"prefill": [], "decode": []}

    def timed(name, fn):
        def step(p, t, c):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = fn(p, t, c)
            torch.cuda.synchronize()
            steps[name].append(time.perf_counter() - t1)
            return out
        return step

    eng._prefill = timed("prefill", eng._prefill)
    eng._decode = timed("decode", eng._decode)
    gc.collect()   # the peak counts what is alive, garbage included
    base = torch.cuda.memory_allocated() / 2 ** 20
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    reqs = [eng.submit(p, max_new=ref["max_new"]) for p in prompts]
    eng.run()
    wall = time.perf_counter() - t1
    tokens = sum(len(r.out) for r in reqs)
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    numbers = dict(prefill_ms=steps["prefill"][0] * 1e3,
                   decode_ms=float(np.mean(steps["decode"])) * 1e3,
                   tokens=tokens, wall_s=wall, tokens_per_s=tokens / wall,
                   peak_mib=peak, base_mib=base)
    print(f"serving lightpe1 (warm): prefill {numbers['prefill_ms']:.3f} ms "
          f"(4 x {max(len(p) for p in prompts)} tokens), decode "
          f"{numbers['decode_ms']:.3f} ms/step, {tokens} tokens in "
          f"{wall:.3f} s = {numbers['tokens_per_s']:.1f} tokens/s, peak "
          f"device memory {peak:.1f} MiB ({base:.1f} MiB before the run)")
    qmm, fa = time_serving_kernels(torch, dev, cfg, packs["lightpe1"],
                                   max(len(p) for p in prompts) + 5)
    return launches, qmm, fa, numbers


def run_qat_serving(torch, dev):
    """Phase 7: SmolLM-135M at full width on its dense numpy-drawn weights
    under the QAT numerics of every quantizing PE type (fake-quantized
    float32 weights, activations in the compute type: bfloat16 reaches
    fake_quant), served by ``ServeEngine`` (4 prompts in 4 slots) and held
    to the JAX package's runs; fake_quant launches counted per run."""
    import numpy as np
    from repro_torch import convert
    from repro_torch.configs import get
    from repro_torch.kernels.fake_quant import fake_quant
    from repro_torch.models import family_module
    from repro_torch.serve import ServeEngine, check

    ref = json.loads(SERVE_REF.read_text())
    cfg = get(ref["config"])
    mod = family_module(cfg)
    params = convert.params_from_numpy(mod.numpy_params(cfg, ref["param_seed"]),
                                       dev)
    prompts = [np.array(p) for p in ref["prompts"]]
    runs, records = {}, {}
    for key, m in ref["qat_modes"].items():
        run_cfg = cfg.replace(pe_type=m["pe_type"], dtype=m["dtype"])
        eng = ServeEngine(run_cfg, mod, params, ref["batch_slots"],
                          ref["max_len"])
        fake_quant.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = check.record(eng, prompts, ref["max_new"],
                           lambda t: t.float().cpu().numpy())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fake_quant.launches
        want = ref["max_new"] * (cfg.n_layers * QAT_PROJECTIONS + 1) \
            * QAT_PASSES[m["pe_type"]]
        if launches != want:
            fail(f"qat {key}: the run launched fake_quant {launches} times, "
                 f"expected {want}")
        problems, notes = check.compare(rec, m["run4"], QAT_TOL[key],
                                        coupled=True)
        for note in notes:
            print(f"  tolerated (qat {key}): {note}")
        if problems:
            fail(f"qat {key} differs from the JAX reference: "
                 + "; ".join(problems))
        err = check.max_logit_err(rec, m["run4"], coupled=True)
        steps = check.compared_steps(rec, m["run4"], coupled=True)
        runs[key] = dict(fake_quant_launches=launches, wall_s=wall,
                         max_logit_err=err, tolerance=QAT_TOL[key],
                         steps_compared=steps, tolerated=notes)
        records[key] = rec
        print(f"qat {key}: matches the JAX reference (max logit err "
              f"{err:.3g}, tolerance {QAT_TOL[key]}, steps compared "
              f"{steps} of {ref['max_new']}, {len(notes)} notes); "
              f"{launches} fake_quant launches, {wall:.3f} s for 4 x "
              f"{ref['max_new']} tokens; tokens of request 0: "
              f"{rec['tokens'][0]}")

    # the control: bfloat16 numerics held to the float32 reference must
    # not pass at the float32 mode's tolerance
    ran, against = QAT_CONTROL
    want = ref["qat_modes"][against]["run4"]
    problems, _ = check.compare(records[ran], want, QAT_TOL[against],
                                coupled=True)
    err = check.max_logit_err(records[ran], want, coupled=True)
    steps = check.compared_steps(records[ran], want, coupled=True)
    runs["control"] = dict(run=ran, reference=against, max_logit_err=err,
                           tolerance=QAT_TOL[against], steps_compared=steps,
                           problems=problems)
    print(f"qat control: the {ran} run held to the {against} reference: max "
          f"logit err {err:.3g} (tolerance {QAT_TOL[against]}), steps "
          f"compared {steps}; {len(problems)} problems")
    if not problems:
        fail(f"qat control: the {ran} run passes against the {against} "
             f"reference at {QAT_TOL[against]}, so that tolerance cannot "
             f"tell the two compute types apart")
    return runs


def run_coexplore(torch, dev, surrogate):
    """Phase 8: the joint co-exploration walks at full size, held to the
    JAX package's results and to the port's bitwise contracts."""
    import numpy as np
    from repro_torch import coexplore_check as check
    from repro_torch.core import coexplore
    from repro_torch.core.constraints import Budget

    ref = json.loads(COEX_REF.read_text())
    models = coexplore.default_model_set(device=dev)
    if [m.name for m in models] != ref["models"]:
        fail(f"default_model_set {[m.name for m in models]} != reference")
    if not np.array_equal(coexplore.accuracy_matrix(models),
                          np.asarray(ref["accuracy_matrix"])):
        fail("the accuracy matrix differs from the JAX reference")
    walks = {}
    card = card_line()

    def walk(tag, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        front = coexplore.coexplore_front(models, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = front.points_evaluated
        walks[tag] = dict(points=n, wall_s=dt, points_per_s=n / dt,
                          front=len(front.archive))
        print(f"coexplore {tag}: {n} joint points in {dt:.3f} s = "
              f"{n / dt:.0f} points/s, front {len(front.archive)} ({card})")
        return front

    def held(tag, front, run):
        problems, notes = check.compare(
            check.summary(front, coexplore.coexplore_report(front)),
            ref["runs"][run])
        for n in notes:
            print(f"tolerated: {tag}: {n}")
        if problems:
            fail(f"coexplore {tag} differs from the JAX reference: "
                 + "; ".join(problems))
        print(f"coexplore {tag} matches the JAX reference ({run})")

    def same(tag, a, b):
        diff = check.identical(a, b)
        if diff:
            fail(f"coexplore {tag} differ: " + "; ".join(diff))
        print(f"coexplore {tag}: bitwise equal")

    mixed = walk("mixed")
    held("mixed", mixed, "unconstrained")
    claim = coexplore.lightpe_claim(mixed)
    oks = [v["ok"] for v in claim["per_model"].values()]
    print(f"LightPE claim holds for {sum(o is True for o in oks)} of "
          f"{len(oks)} models; front by PE type "
          f"{coexplore.coexplore_report(mixed)['front_counts']['by_pe_type']}")
    same("mixed / per-model", mixed, walk("per-model", mix_models=False))
    area = Budget(area_mm2=0.9)
    pruned = walk("area<=0.9 two-stage", budget=area)
    held("area<=0.9 two-stage", pruned, "area_0.9")
    print(f"area<=0.9: {pruned.budget_stats}")
    same("area<=0.9 two-stage / single-stage", pruned,
         walk("area<=0.9 single-stage", budget=area, prune=False))
    spec = check.RUNS["budget_4500"]
    sub = walk("4500 area<=2 power<=250", max_points=spec["max_points"],
               budget=Budget(**spec["budget"]))
    held("4500 area<=2 power<=250", sub, "budget_4500")
    print(f"4500 area<=2 power<=250: {sub.budget_stats}")
    same("surrogate mixed / per-model",
         walk("surrogate 4500 mixed", surrogate=surrogate,
              max_points=check.SUBSAMPLE),
         walk("surrogate 4500 per-model", surrogate=surrogate,
              max_points=check.SUBSAMPLE, mix_models=False))
    return walks, dict(mixed=mixed, pruned=pruned)


def run_scale(torch, dev, fronts):
    """Phase 9: DSE at scale (sharded, checkpointed, searched and served
    walks, telemetry), held to phase 8's walks, to the port's bitwise
    contracts and to ``tests/data/torch_scale_ref.json``."""
    import csv
    import itertools
    import tempfile

    import numpy as np
    from repro_torch import coexplore_check as check
    from repro_torch import scale_check as S
    from repro_torch.core import coexplore, dse, search, workloads
    from repro_torch.core.arch import (DEFAULT_SPACE, MAPPED_SPACE,
                                       WIDE_SPACE)
    from repro_torch.core.constraints import Budget
    from repro_torch.obs import (Tracer, build_sweep_report, chrome_trace,
                                 trace_lanes)
    from repro_torch.serve import FrontCache, FrontServer

    ref = json.loads(SCALE_REF.read_text())
    models = coexplore.default_model_set(device=dev)
    if [m.name for m in models] != ref["models"]:
        fail(f"default_model_set {[m.name for m in models]} != reference")
    card = card_line()
    out = {}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_scale_"))

    def timed(tag, fn, points=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = points(res) if points is not None else res.points_evaluated
        out[tag] = dict(points=n, wall_s=dt, points_per_s=n / dt)
        print(f"scale {tag}: {n} points in {dt:.3f} s = {n / dt:.0f} "
              f"points/s ({card})")
        return res

    def same(tag, a, b, rows=False):
        diff = check.identical(a, b)
        if rows and not diff and not (
                np.array_equal(a.archive.indices, b.archive.indices)
                and np.array_equal(a.archive.objectives,
                                   b.archive.objectives)):
            diff = ["row order"]
        if diff:
            fail(f"scale {tag} differ: " + "; ".join(diff))
        print(f"scale {tag}: bitwise equal" + (", row order included"
                                               if rows else ""))

    # 1. the sharded joint walk with telemetry, against phase 8's walks
    shard_kw = dict(shards=SCALE_SHARDS, pipeline_depth=SCALE_DEPTH)
    tr = Tracer(rss_interval_s=0.25)
    sharded = timed("sharded joint walk", lambda: coexplore.coexplore_front(
        models, telemetry=tr, **shard_kw))
    wall = out["sharded joint walk"]["wall_s"]
    tr.close()
    same("sharded (4) / phase 8 mixed", sharded, fronts["mixed"])
    if coexplore.lightpe_claim(sharded) != coexplore.lightpe_claim(
            fronts["mixed"]):
        fail("scale: the sharded walk's LightPE claim differs from phase 8's")
    lanes = sorted(k for k in trace_lanes(chrome_trace(tr))
                   if k.startswith("shard"))
    if lanes != [f"shard{i}" for i in range(SCALE_SHARDS)]:
        fail(f"scale: Chrome trace lanes {lanes}, expected "
             f"{SCALE_SHARDS} shard lanes")
    report = build_sweep_report(tr, wall_s=wall)
    phases = {k: report.attribution.get(k, {}).get("seconds", 0.0)
              for k in ("decode", "dispatch", "device_wait", "archive")}
    if any(v > wall for v in phases.values()) or \
            sum(phases.values()) > wall * 1.05:
        fail(f"scale: report phases {phases} do not fit in the wall time "
             f"{wall:.3f} s")
    out["sharded joint walk"].update(
        report={k: dict(seconds=v["seconds"], share=v["share"],
                        count=v["count"])
                for k, v in report.attribution.items()},
        coverage=report.coverage, n_compiles=report.n_compiles,
        lanes=len(lanes))
    print(f"scale sharded joint walk report (trace lanes {lanes}):")
    print(report.render())
    area = Budget(area_mm2=0.9)
    pruned = timed("sharded area<=0.9 two-stage",
                   lambda: coexplore.coexplore_front(models, budget=area,
                                                     **shard_kw))
    same("sharded area<=0.9 / phase 8", pruned, fronts["pruned"])
    st = pruned.budget_stats
    if (st.feasible, st.pruned) != (60_216, 290_784):
        fail(f"scale: sharded area<=0.9 feasible/pruned {st.feasible}/"
             f"{st.pruned}, expected 60216/290784")
    print(f"scale sharded area<=0.9: {st}")

    # 2. kill and resume from the checkpoint
    ck = str(tmp / "joint")
    part = timed("killed after 40 chunks", lambda: coexplore.coexplore_front(
        models, checkpoint_dir=ck, max_chunks=KILL_AFTER, **shard_kw))
    resumed = timed("resumed", lambda: coexplore.coexplore_front(
        models, checkpoint_dir=ck, **shard_kw))
    head = sum(len(c[-1]) for c in itertools.islice(
        coexplore.plan_joint_walk(models).chunks(), KILL_AFTER))
    if part.points_evaluated != head:
        fail(f"scale: the killed walk evaluated {part.points_evaluated} "
             f"points, not its first {KILL_AFTER} chunks' {head}")
    same("resumed / uninterrupted", resumed, sharded, rows=True)
    try:
        coexplore.coexplore_front(models, checkpoint_dir=ck, shards=2)
    except ValueError as e:
        if "different sweep" not in str(e):
            raise
        print("scale: a checkpoint of another sweep is refused")
    else:
        fail("scale: a checkpoint with another signature was resumed")

    # 3. the wide sweep, sharded, the front streamed to CSV
    wl = workloads.vgg16("cifar10", device=dev)
    wide_kw = dict(max_points=WIDE_POINTS, chunk_size=WIDE_CHUNK)
    csv_path = tmp / "wide_front.csv"
    plain_wide = timed("WIDE 2^20 unsharded", lambda: dse.pareto_front_streaming(
        wl, WIDE_SPACE, **wide_kw)[0], points=lambda a: WIDE_POINTS)
    wide = timed("WIDE 2^20 sharded", lambda: dse.pareto_front_streaming(
        wl, WIDE_SPACE, shards=SCALE_SHARDS, csv_path=str(csv_path),
        **wide_kw)[0], points=lambda a: WIDE_POINTS)
    o1, o2 = np.argsort(plain_wide.indices), np.argsort(wide.indices)
    if not (np.array_equal(plain_wide.indices[o1], wide.indices[o2])
            and np.array_equal(plain_wide.objectives[o1],
                               wide.objectives[o2])):
        fail("scale: the sharded WIDE_SPACE front differs from the unsharded")
    with open(csv_path) as f:
        rows = list(csv.DictReader(f))
    if [int(r["index"]) for r in rows] != wide.indices.tolist() or any(
            [float(r[m]) for m in ("perf_per_area", "neg_energy_j")]
            != wide.objectives[i].tolist() for i, r in enumerate(rows)):
        fail("scale: the CSV rows are not the sharded front")
    print(f"scale WIDE 2^20: sharded / unsharded bitwise equal, front "
          f"{len(wide)} points, CSV rows = front")

    # 4. budgeted search over 3 models x MAPPED_SPACE
    three = models[:S.N_MODELS]
    ref_front = ref["ref_space"]["front"]
    enum = timed("REF_SPACE enumeration", lambda: coexplore.coexplore_front(
        three, space=S.ref_space(DEFAULT_SPACE), seed=S.SEED))
    ok, ties, bad = S._archives_close(S.front_data(enum.archive), ref_front,
                                      check.RTOL)
    if bad:
        fail(f"scale: the REF_SPACE front differs from the reference: {bad}")
    print(f"scale REF_SPACE front: {len(enum.archive)} points, "
          f"{len(ties)} near ties against the reference")
    out["search"] = {}
    for name, make in S.DRIVERS.items():
        runs = []
        for shards in (None, SCALE_SHARDS):
            rec = S.Recorder(make(search))
            if shards is None:
                first = rec
            front = timed(f"search {name} shards={shards or 1}",
                          lambda: search.search_front(
                              three, space=MAPPED_SPACE, driver=rec,
                              max_evals=S.SEARCH_EVALS, seed=S.SEED,
                              shards=shards))
            runs.append((rec, front))
        (_, front), (_, front4) = runs
        rec = first
        if not (np.array_equal(front.archive.indices, front4.archive.indices)
                and np.array_equal(front.archive.objectives,
                                   front4.archive.objectives)):
            fail(f"scale: search {name}: shards 1 and 4 differ")
        # against the port's REF_SPACE front (held to the reference's
        # above): coverage's ">= in every objective" is exact, so a
        # searched point that is itself a REF_SPACE front point covers
        # it only against objectives of the same package
        got = dict(log=rec.log, front=S.front_data(front.archive),
                   points_evaluated=int(front.points_evaluated),
                   **S.quality(search.hypervolume, search.front_coverage,
                               front.archive.objectives,
                               enum.archive.objectives))
        want = ref["search"][name]
        problems, notes = S.compare_search(
            got, want, explain=lambda g, p, rec=rec: S.halving_ties(rec, g, p),
            order_matters=name == "evolve")
        for n in notes:
            print(f"  tolerated (search {name}): {n}")
        if problems:
            fail(f"scale: search {name} differs from the JAX reference: "
                 + "; ".join(problems))
        out["search"][name] = dict(
            front=len(front.archive), hv_ratio=got["hv_ratio"],
            coverage=got["coverage"], ref_hv_ratio=want["hv_ratio"],
            ref_coverage=want["coverage"], generations=len(rec.log),
            notes=notes)
        print(f"scale search {name}: front {len(front.archive)}, hv_ratio "
              f"{got['hv_ratio']:.6f} (reference {want['hv_ratio']:.6f}), "
              f"coverage {got['coverage']:.3f} (reference "
              f"{want['coverage']:.3f}), shards 1 / 4 bitwise equal, "
              f"{len(notes)} notes")

    # 5. the front server: the 12-query storm on one shared walk
    budgets = [None if b is None else Budget(**b)
               for b in S.DISTINCT_BUDGETS]
    srv = FrontServer(models)
    qs = []

    def storm():
        qs.extend(srv.submit(budgets[i]) for i in S.STORM)
        srv.run()
        return srv
    timed("front server storm (12 queries)", storm,
          points=lambda _: max(q.response.points_evaluated for q in qs))
    n_chunks = sum(1 for _ in srv._plan.chunks())
    if srv.chunk_evals != n_chunks or srv.chunk_evals != \
            ref["storm"]["chunk_evals"]:
        fail(f"scale: the storm took {srv.chunk_evals} chunk evaluations, "
             f"not one walk of {n_chunks}")
    for i, want in enumerate(ref["storm"]["responses"]):
        problems, notes = S.compare_storm(S.storm_data(qs[i].response), want,
                                          want["near_bound"])
        for n in notes:
            print(f"  tolerated (storm {want['budget']}): {n}")
        if problems:
            fail(f"scale: storm query {want['budget']} differs from the JAX "
                 f"reference: " + "; ".join(problems))
    print(f"scale storm: 12 queries in one walk of {srv.chunk_evals} chunks; "
          f"the 8 distinct fronts match the JAX reference")
    for i in S.SPOT_CHECK:
        alone = coexplore.coexplore_front(models, budget=budgets[S.STORM[i]],
                                          prune=False)
        resp = qs[i].response
        if not (np.array_equal(resp.archive.indices, alone.archive.indices)
                and np.array_equal(resp.archive.objectives,
                                   alone.archive.objectives)):
            fail(f"scale: storm query {i} differs from its standalone walk")
    print(f"scale storm: queries {S.SPOT_CHECK} bitwise equal to standalone "
          f"walks, row order included")
    evals = srv.chunk_evals
    again = srv.query(budgets[1])
    if srv.chunk_evals != evals or again.served_from != "cache:repeat":
        fail(f"scale: a repeat query took {srv.chunk_evals - evals} chunk "
             f"evaluations ({again.served_from})")
    cache_dir = str(tmp / "frontcache")
    srv.cache.save(cache_dir)
    fresh = FrontServer(models, cache=FrontCache())
    fresh.cache.load(cache_dir)
    restored = fresh.query(budgets[1])
    if fresh.chunk_evals != 0 or not np.array_equal(
            restored.archive.indices, qs[1].response.archive.indices):
        fail("scale: a restored cache did not answer with 0 chunk "
             "evaluations")
    print("scale storm: a repeat and a restored cache answer with 0 chunk "
          "evaluations")
    out["storm"] = dict(chunk_evals=srv.chunk_evals,
                        fronts=[len(qs[i].response.archive)
                                for i in range(len(budgets))])

    # 6. phase 6's LightPE-1 bfloat16 run with telemetry on
    out["serving_telemetry"] = serve_with_telemetry(torch, dev)
    return out


def serve_with_telemetry(torch, dev):
    """Phase 6's LightPE-1 4 x 12 run twice, telemetry off and on: tokens
    and logits bitwise equal, the kernels launched as on the main path
    and the engine's counts."""
    import numpy as np
    from repro_torch import convert
    from repro_torch.configs import get
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.quant_matmul import quant_matmul
    from repro_torch.models import family_module
    from repro_torch.obs import Tracer
    from repro_torch.serve import ServeEngine, check, quantize_params

    ref = json.loads(SERVE_REF.read_text())
    cfg = get(ref["config"])
    mod = family_module(cfg)
    params = convert.params_from_numpy(mod.numpy_params(cfg, ref["param_seed"]),
                                       dev)
    packed = quantize_params(params, "lightpe1", min_size=ref["min_size"])
    prompts = [np.array(p) for p in ref["prompts"]]

    def run(tr):
        eng = ServeEngine(cfg, mod, packed, ref["batch_slots"],
                          ref["max_len"], telemetry=tr)
        return check.record(eng, prompts, ref["max_new"],
                            lambda t: t.float().cpu().numpy())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = run(None)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    tr = Tracer(rss_interval_s=0)
    quant_matmul.launches = 0
    flash_attention.launches = 0
    t0 = time.perf_counter()
    traced = run(tr)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"quant_matmul": quant_matmul.launches,
              "flash_attention": flash_attention.launches}
    if counts != SERVE_LAUNCHES:
        fail(f"serving with telemetry: launches {counts}, expected "
             f"{SERVE_LAUNCHES}")
    if traced["tokens"] != plain["tokens"] or any(
            not np.array_equal(np.asarray(a), np.asarray(b))
            for a, b in zip(traced["logits"], plain["logits"])):
        fail("serving with telemetry: tokens or logits differ from the run "
             "with telemetry off")
    reg = tr.registry
    got = (reg.counters["serve.requests"].value,
           reg.counters["serve.tokens"].value)
    if got != (len(prompts), len(prompts) * ref["max_new"]):
        fail(f"serving with telemetry: serve.requests / serve.tokens {got}")
    spans = {k: reg.histograms[f"serve.{k}"].summary()
             for k in ("prefill", "decode")}
    print(f"serving with telemetry: tokens and logits bitwise equal to the "
          f"run without; launches {counts}; serve.requests {got[0]:.0f}, "
          f"serve.tokens {got[1]:.0f}; prefill p50 "
          f"{spans['prefill']['p50'] * 1e3:.3f} ms, decode p50 "
          f"{spans['decode']['p50'] * 1e3:.3f} ms; {wall:.3f} s traced, "
          f"{plain_wall:.3f} s without")
    return dict(launches=counts, requests=got[0], tokens=got[1],
                wall_s=wall, plain_wall_s=plain_wall, prefill=spans["prefill"],
                decode=spans["decode"])


def main() -> int:
    sys.stdout.reconfigure(line_buffering=True)  # progress survives a kill
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a CUDA card")
    if not (ROOT / "src" / "repro_torch").is_dir() or not REF.exists() \
            or not SERVE_REF.exists() or not COEX_REF.exists() \
            or not SCALE_REF.exists():
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
        print(f"  {name}: {secs:.2f} s; ptxas: {ptxas_summary(output)}")

    modes = check_kernels(torch, dev)
    model_shapes = check_model_shapes(torch, dev)
    launches, surrogate = run_slice(torch, dev)
    qmm_err, fa_err = check_serving_kernels(torch, dev)
    serve_launches, qmm, fa, serving = run_serving(torch, dev)
    qat = run_qat_serving(torch, dev)
    t8 = time.perf_counter()
    coex, fronts = run_coexplore(torch, dev, surrogate)
    print(f"phase 8 (co-exploration): {time.perf_counter() - t8:.2f} s")
    t9 = time.perf_counter()
    scale = run_scale(torch, dev, fronts)
    print(f"phase 9 (DSE at scale): {time.perf_counter() - t9:.2f} s")

    # the row's main numbers: one grouped launch over the 15 VGG-16
    # weights, affine-8, float32; the bfloat16 and per-weight times beside
    main, bf16 = modes[("float32", "affine", 8)], modes[("bfloat16", "affine", 8)]
    kernels = [dict(
        name="fake_quant", route="cuda",
        source="src/repro_torch/csrc/fake_quant.cu",
        replaces="src/repro/kernels/fake_quant/fake_quant.py:45",
        launches=launches, max_abs_err=max(m["max_abs_err"]
                                           for m in modes.values()),
        differing=sum(m["differing"] for m in modes.values()),
        ms=main["ms"], per_weight_ms=main["per_weight_ms"],
        cold_ms=main["cold_ms"], bf16_ms=bf16["ms"],
        plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
        bound_bf16_ms=bf16["bound_ms"], bound_by=main["bound_by"],
        library_ms=main["library_ms"],
        unit="15 VGG-16/CIFAR-10 weights, one grouped launch",
        smollm_elements_compared=model_shapes,
        qat_serving_launches={k: r["fake_quant_launches"]
                              for k, r in qat.items() if k != "control"},
        modes=list(modes.values()))]
    # the rows' main numbers are one decode step's (11 of the 12 steps);
    # the prefill step's stand beside them
    for name, rows, err, replaces, library in (
            ("quant_matmul", qmm, qmm_err,
             "src/repro/kernels/quant_matmul/quant_matmul.py:106",
             "torch.matmul on the dequantized float32 weights (no single "
             "call computes the packed product)"),
            ("flash_attention", fa, fa_err,
             "src/repro/kernels/flash_attention/flash_attention.py:71",
             "scaled_dot_product_attention with the same mask, enable_gqa")):
        kernels.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{name}.cu",
            replaces=replaces, launches=serve_launches[name],
            max_abs_err=err, ms=rows["decode"]["ms"],
            plain_ms=rows["decode"]["plain_ms"],
            bound_ms=rows["decode"]["bound_ms"],
            bound_by=rows["decode"]["bound_by"],
            library_ms=rows["decode"]["library_ms"], library=library,
            unit="one decode step of SmolLM-135M, 4 slots, LightPE-1",
            prefill=rows["prefill"]))
        if name == "flash_attention":
            kernels[-1].update(variant={p: r["variant"] for p, r in
                                        rows.items() if p != "bf16_q"},
                               bound_f32_ms=rows["decode"]["bound_f32_ms"],
                               bf16_q=rows["bf16_q"])
        if name == "quant_matmul":
            kernels[-1].update(
                variant={p: r["variant"] for p, r in rows.items()},
                bound_f32_ms=rows["decode"]["bound_f32_ms"],
                per_projection_ms=rows["decode"]["per_projection_ms"])
    print(json.dumps({"kernels": kernels, "serving": serving, "qat": qat,
                      "coexplore": coex, "scale": scale}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
