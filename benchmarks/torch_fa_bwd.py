"""The port's attention backward kernels (``csrc/flash_attention_bwd.cu``
up to head_dim 64, ``csrc/flash_attention_bwd_wgmma.cuh`` at 112, 128 and
256) on the card: times, a phase breakdown, and the property the designs
rest on.

  python3 benchmarks/torch_fa_bwd.py [--probe] [--symmetry]
                                     [--only NAME ...] [--src OTHER/src]
                                     [--out results/torch/fa_bwd.json]

At SmolLM-135M's training shape (16 x 256, GQA 9/3, head_dim 64) and the
family training shapes of ``chip_smoke.py``'s phase 16.1 (Gemma-3-1B's
local and global layers, 2 x 1024, 4/1 heads of 256; Gemma-2-9B's, 4,608
tokens, 16/8 heads of 256, window 4,096, soft-cap 50; Zamba2-7B's shared
attention, 2 x 512, 32/32 heads of 112), in float32 and bfloat16, with
``round_p``:
- the kernels' time (one backward: the packing launch where there is one
  and both kernels) and each kernel's device time from
  ``torch.profiler``; SDPA's backward on the same inputs where there is no
  soft-cap (the window as a boolean mask); the kernels are held to the
  plain version first (``train_check.attention_grad_errors``).  A time
  is the mean over 10 calls queued behind a sleep kernel, so the events
  see the device only;
- ``--probe``: a copy of the source with ``clock64`` probes between the
  kernels' phases (thread 0 of every block: the first consumer warpgroup
  of the wgmma kernels), built beside the real one: each phase's share of
  a block's cycles and its cycles per chunk of keys (rows kernel) or tile
  of rows (keys kernel), at SmolLM-135M's shape, Gemma-3-1B's global
  layer and Zamba2-7B's.  The probes sit on the source's ``// PROBE``
  comment lines, which the kernels' build ignores;
- ``--src``: the package (and the kernel sources the probes read) from
  another checkout's ``src``, its kernels built under that checkout's
  ``build/``: run parent, change, change, parent in one call to compare
  two trees on one card;
- ``--symmetry``: whether ``mma.sync.m16n8k16`` (bf16 in, float32
  accumulators) gives (A B)[i][j] and (B^T A^T)[j][i] with the same bits
  over a chain of bf16 part products (the mma.sync kernels form S^T in
  their keys kernel where their rows kernel forms S); and, for every
  backward instance of the tree at 112, 128 and 256, the one-logit
  invariant itself: with a window of 1 every row sees one key, so P = 1
  and dS = 0 exactly wherever the keys kernel's logit has the rows
  kernel's bits, and dq and dk must be exactly 0.
"""

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

# (name, b, s, hq, hkv, d, window, softcap, config)
SHAPES = [
    ("smollm", 16, 256, 9, 3, 64, 0, 0.0, "smollm-135m"),
    ("gemma3_local", 2, 1024, 4, 1, 256, 512, 0.0, "gemma3-1b"),
    ("gemma3_global", 2, 1024, 4, 1, 256, 0, 0.0, "gemma3-1b"),
    ("gemma2_local", 1, 4608, 16, 8, 256, 4096, 50.0, "gemma2-9b"),
    ("gemma2_global", 1, 4608, 16, 8, 256, 0, 50.0, "gemma2-9b"),
    ("zamba2_shared", 2, 512, 32, 32, 112, 0, 0.0, "zamba2-7b"),
]
PROBED = ("smollm", "gemma3_global", "zamba2_shared")
REPS = 10
SLEEP_CYCLES = 100_000_000
WIDE = (112, 128, 256)

# phases by source: flash_attention_bwd.cu (mma.sync), and the wgmma
# kernels (warpgroup 0's view: its S, the wait for warpgroup 1's dP, ...)
PHASES = {
    "flash_attention_bwd": (
        ["prologue", "pass 1 wait", "pass 1 split", "pass 1 copy + S, dP",
         "pass 1 online", "merge", "pass 2 wait + split",
         "pass 2 copy + S, dP", "pass 2 dS + dq", "dq halves"],
        ["prologue", "wait", "split + copy", "S^T, dP^T", "P^T, dS^T",
         "dv, dk"]),
    "flash_attention_bwd_wgmma": (
        ["prologue", "S (both passes)", "dP hand-over", "online statistics",
         "dS to shared memory", "dq products", "dq store"],
        ["prologue", "S", "statistics + dP hand-over",
         "P, dS to shared memory", "dv products", "dv store"]),
}


def probed_source(src: str) -> str:
    """The kernel's source with its ``// PROBE`` comment lines made code:
    ``PROBE n`` adds the cycles since the last probe to phase n, ``PROBE
    start`` starts the clock, ``PROBE dump <buffer> <phases> <units>``
    writes thread 0's phases, its total cycles and its count of chunks or
    tiles to the block's slot of the buffer.  Each kernel (rows, then
    keys) must start, cover every phase below its count, and dump."""
    def line(m):
        ind, what = m.group(1), m.group(2).split()
        if what[0] == "start":
            return (f"{ind}long long acc_[12] = {{0}}; long long last_ = "
                    "clock64(); const long long t0_ = last_;")
        if what[0] == "dump":
            buf, n, units = what[1:]
            return (f"{ind}if (tid == 0) {{ long long* o = {buf} + 16 * "
                    "((blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + "
                    f"blockIdx.x); for (int i = 0; i < {n}; ++i) o[i] = "
                    f"acc_[i]; o[10] = clock64() - t0_; o[11] = {units}; }}")
        return f"{ind}PROBE({int(what[0])});"
    marks = re.findall(r"^\s*// PROBE (.+?)\s*$", src, flags=re.M)
    dumps, seen = [], None
    for mark in marks:
        what = mark.split()
        if what[0] == "start":
            seen = set()
        elif what[0] == "dump":
            if seen is None or seen != set(range(int(what[2]))):
                raise SystemExit(f"the PROBE lines before {mark!r} do not "
                                 f"cover its phases: {sorted(seen or ())}")
            dumps.append(what[1])
            seen = None
        else:
            seen.add(int(what[0]))
    if dumps != ["g_dbg_rows", "g_dbg_keys"]:
        raise SystemExit(f"the kernel's PROBE dumps are {dumps}")
    s = re.sub(r"^(\s*)// PROBE (.+)$", line, src, flags=re.M)
    return ("__device__ long long* g_dbg_rows;\n"
            "__device__ long long* g_dbg_keys;\n"
            "#define PROBE(i) { const long long _n = clock64(); "
            "acc_[i] += _n - last_; last_ = _n; }\n" + s + """
extern "C" int set_dbg(void* rows, void* keys) {
  cudaMemcpyToSymbol(g_dbg_rows, &rows, sizeof(void*));
  return (int)cudaMemcpyToSymbol(g_dbg_keys, &keys, sizeof(void*));
}
""")


def nvcc(src: str, name: str):
    from repro_torch.kernels import _build
    out_dir = ROOT / "build" / "bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, lib = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    cu.write_text(src)
    run = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                          str(cu)], capture_output=True, text=True)
    if run.returncode:
        raise SystemExit(f"nvcc failed for {name}:\n{run.stdout}{run.stderr}")
    return ctypes.CDLL(str(lib))


def inputs(torch, shape, dtype, seed=0):
    _, b, s, hq, hkv, d = shape[:6]
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, s, hq, d), generator=g, device="cuda").to(dtype)
    k, v = (torch.randn((b, s, hkv, d), generator=g, device="cuda").to(dtype)
            for _ in range(2))
    do = torch.randn((b, s, hq, d), generator=g, device="cuda")
    return q, k, v, do, torch.zeros(b, dtype=torch.int32, device="cuda")


def scale_of(shape):
    from repro_torch.configs import get
    return get(shape[8]).query_scale or shape[5] ** -0.5


def device_ms(torch, fn):
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def kernel_source(src_dir: Path, source: str) -> str:
    """``csrc/<source>.cu`` of ``src_dir`` with its own header
    (``<source>.cuh``, where the wgmma kernels live) written in place of
    its include, so that the probes reach the kernels."""
    csrc = src_dir / "repro_torch" / "csrc"
    text = (csrc / f"{source}.cu").read_text()
    header = csrc / f"{source}.cuh"
    if header.exists():
        text = text.replace(f'#include "{source}.cuh"', header.read_text())
    return text


def source_of(src_dir: Path, d: int) -> str:
    """The backward source of ``src_dir`` that serves head_dim d."""
    wide = src_dir / "repro_torch" / "csrc" / "flash_attention_bwd_wgmma.cu"
    return ("flash_attention_bwd_wgmma" if d in WIDE and wide.exists()
            else "flash_attention_bwd")


def times(torch, src_dir, shapes):
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.flash_attention import attention_backward
    from repro_torch.kernels.flash_attention.ref import ref_attention_gqa_bwd
    from repro_torch.train_check import attention_grad_errors
    rows = {}
    for shape in shapes:
        name, b, s, hq, hkv, d, window, softcap = shape[:8]
        sc = scale_of(shape)
        kw = dict(round_p=True, scale=sc, window=window, softcap=softcap)
        for dtype in (torch.float32, torch.bfloat16):
            key = f"{name}_{str(dtype).split('.')[1]}"
            q, k, v, do, st = inputs(torch, shape, dtype)
            err = attention_grad_errors(
                attention_backward(q, k, v, st, do, **kw),
                ref_attention_gqa_bwd(q, k, v, st, do, True, sc, True,
                                      window, softcap), do)
            if not err["ok"]:
                raise SystemExit(f"backward kernel {key}: {err}")
            kernel = lambda: attention_backward(q, k, v, st, do,  # noqa: E731
                                                **kw)
            row = dict(kernel_ms=device_ms(torch, kernel),
                       max_abs_err=err["max_abs_err"],
                       source=source_of(src_dir, d))
            if not softcap:
                tq, tk, tv = (t.transpose(1, 2).detach().requires_grad_()
                              for t in (q, k, v))
                pos = torch.arange(s, device="cuda")
                mask = pos[None, :] <= pos[:, None]
                if window:
                    mask &= pos[None, :] > pos[:, None] - window
                out = sdpa(tq, tk, tv, attn_mask=mask, scale=sc,
                           enable_gqa=True)
                tdo = do.transpose(1, 2).to(out.dtype)
                row["sdpa_ms"] = device_ms(torch, lambda: torch.autograd.grad(
                    out, (tq, tk, tv), tdo, retain_graph=True))
                del tq, tk, tv, out, tdo, mask
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(REPS):
                    kernel()
                torch.cuda.synchronize()
            for e in prof.key_averages():
                for kname in ("rows_kernel", "keys_kernel", "pack_kernel"):
                    if kname in e.key and e.count:
                        row[f"{kname}_ms"] = (e.device_time_total / e.count
                                              / 1e3)
            rows[key] = row
            print(f"{key}: backward {row['kernel_ms']:.4f} ms (rows "
                  f"{row.get('rows_kernel_ms', 0):.4f}, keys "
                  f"{row.get('keys_kernel_ms', 0):.4f}, packing "
                  f"{row.get('pack_kernel_ms', 0):.4f}), SDPA backward "
                  f"{row.get('sdpa_ms', float('nan')):.4f} ms, max |err| "
                  f"vs plain {row['max_abs_err']:.3g} [{row['source']}]",
                  flush=True)
            del q, k, v, do
            torch.cuda.empty_cache()
    return rows


def probe(torch, src_dir: Path, shapes):
    from repro_torch.kernels.flash_attention import flash_attention as fa
    fa_mod = sys.modules[fa.__module__]
    out, libs = {}, {}
    for shape in shapes:
        name, b, s, hq, hkv, d, window, softcap = shape[:8]
        if name not in PROBED:
            continue
        source = source_of(src_dir, d)
        if source not in libs:
            lib = nvcc(probed_source(kernel_source(src_dir, source)),
                       f"{source}_probe")
            fn = getattr(lib, f"{source}_launch")
            wide = source.endswith("wgmma")
            fn.argtypes = ([ctypes.c_void_p] * (10 if wide else 9)
                           + [ctypes.c_int] * 7 + [ctypes.c_float]
                           + [ctypes.c_int] * 3 + [ctypes.c_float]
                           + [ctypes.c_int] * wide + [ctypes.c_void_p])
            lib.set_dbg.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            libs[source] = (lib, fn, wide)
        lib, fn, wide = libs[source]
        rows_names, keys_names = PHASES[source]
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, do, st = inputs(torch, shape, dtype)
            bf16 = dtype == torch.bfloat16
            grads = [torch.empty_like(t) for t in (q, k, v)]
            stats = torch.empty(3 * b * s * hq, device="cuda")
            extra, splits = [], []
            if wide:
                packed = torch.empty(fa_mod.bwd_packed_elems(
                    b, s, s, hq, hkv, d, bf16), dtype=torch.bfloat16,
                    device="cuda")
                extra = [packed.data_ptr()]
                splits = [fa_mod.bwd_key_splits(b, hkv, s)]
            bufs = {n: torch.zeros(16384, 16, dtype=torch.int64,
                                   device="cuda") for n in ("rows", "keys")}
            if lib.set_dbg(bufs["rows"].data_ptr(), bufs["keys"].data_ptr()):
                raise SystemExit("probe: cudaMemcpyToSymbol failed")
            stream = torch.cuda.current_stream().cuda_stream
            for _ in range(3):
                rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        do.data_ptr(), st.data_ptr(),
                        *(x.data_ptr() for x in grads), stats.data_ptr(),
                        *extra, int(bf16), b, s, s, hq, hkv, d,
                        scale_of(shape), 1, 1, window, softcap, *splits,
                        stream)
                if rc:
                    raise SystemExit(f"probe launch failed: CUDA error {rc}")
            torch.cuda.synchronize()
            tag = f"{name}_{str(dtype).split('.')[1]}"
            for kname, names in (("rows", rows_names), ("keys", keys_names)):
                x = bufs[kname].double().cpu()
                x = x[x[:, 10] > 0]          # the blocks that ran
                total, units = x[:, 10], x[:, 11]
                row = dict(blocks=len(x), cycles_mean=total.mean().item(),
                           cycles_max=total.max().item(),
                           units_mean=units.mean().item(), phases={},
                           source=source)
                for i, ph in enumerate(names):
                    row["phases"][ph] = dict(
                        share=(x[:, i].sum() / total.sum()).item(),
                        cycles_per_unit=(x[:, i].sum()
                                         / max(1.0, units.sum())).item())
                out[f"{tag}/{kname}"] = row
                print(f"{tag} {kname} kernel ({source}): {len(x)} blocks, "
                      f"{row['cycles_mean']:.0f} cycles a block (max "
                      f"{row['cycles_max']:.0f}), {row['units_mean']:.2f} "
                      f"{'chunks' if kname == 'rows' else 'tiles'} a block")
                for ph, r in row["phases"].items():
                    print(f"    {ph:28s} {r['share'] * 100:5.1f}%  "
                          f"{r['cycles_per_unit']:8.0f} cycles a unit")
            del q, k, v, do, grads
            torch.cuda.empty_cache()
    return out


SYMMETRY_SRC = r'''
#include <cuda_bf16.h>
#include <stdint.h>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
               "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
                 "r"(b[1]));
}
__device__ uint32_t pair(const uint16_t* m, int r, int c) {
  return (uint32_t)m[r * 16 + c] | ((uint32_t)m[r * 16 + c + 1] << 16);
}
// out[t] = C[t] + sum over the pairs (px, py) of X[t][px] Y[t][py]^T:
// X, Y (T, 3, 16, 16) bf16 parts, rows by depth; C, out (T, 16, 16)
__global__ void chain(const uint16_t* X, const uint16_t* Y, const float* C,
                      const int* pairs, int np, float* out, int trials) {
  const int lane = threadIdx.x, g = lane >> 2, t4 = lane & 3;
  for (int tr = blockIdx.x; tr < trials; tr += gridDim.x) {
    const uint16_t* x = X + (long)tr * 768;
    const uint16_t* y = Y + (long)tr * 768;
    for (int nh = 0; nh < 2; ++nh) {
      float d[4];
      const int c0 = tr * 256 + g * 16 + nh * 8 + 2 * t4;
      d[0] = C[c0]; d[1] = C[c0 + 1]; d[2] = C[c0 + 128]; d[3] = C[c0 + 129];
      for (int p = 0; p < np; ++p) {
        const uint16_t* a = x + pairs[2 * p] * 256;
        const uint16_t* b = y + pairs[2 * p + 1] * 256;
        const uint32_t af[4] = {pair(a, g, 2 * t4), pair(a, g + 8, 2 * t4),
                                pair(a, g, 2 * t4 + 8),
                                pair(a, g + 8, 2 * t4 + 8)};
        const uint32_t bf[2] = {pair(b, nh * 8 + g, 2 * t4),
                                pair(b, nh * 8 + g, 2 * t4 + 8)};
        mma(d, af, bf);
      }
      out[c0] = d[0]; out[c0 + 1] = d[1]; out[c0 + 128] = d[2];
      out[c0 + 129] = d[3];
    }
  }
}
extern "C" int run(const void* X, const void* Y, const void* C,
                   const void* pairs, int np, void* out, int trials) {
  chain<<<256, 32>>>((const uint16_t*)X, (const uint16_t*)Y, (const float*)C,
                     (const int*)pairs, np, (float*)out, trials);
  return (int)cudaGetLastError();
}
'''


def symmetry(torch, trials=20000):
    from repro_torch.kernels.flash_attention.ref import PAIRS
    from repro_torch.kernels.quant_matmul.ref import split_bf16x3
    lib = nvcc(SYMMETRY_SRC, "mma_symmetry")
    lib.run.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p,
                                                ctypes.c_int]
    g = torch.Generator(device="cuda").manual_seed(0)
    t = trials
    q = (torch.randn(t, 16, 16, generator=g, device="cuda")
         * torch.exp(torch.randn(t, 1, 1, generator=g, device="cuda")))
    k = torch.randn(t, 16, 16, generator=g, device="cuda")
    qp, kp = (torch.stack(split_bf16x3(x), 1).contiguous().view(torch.int16)
              for x in (q, k))
    out = {}
    for label, pairs in (("6 part products", PAIRS), ("1", ((0, 0),))):
        fwd = torch.tensor([i for p in pairs for i in p], dtype=torch.int32,
                           device="cuda")
        swp = torch.tensor([i for p in pairs for i in p[::-1]],
                           dtype=torch.int32, device="cuda")
        for acc in ("random", "zero"):
            c = (torch.randn(t, 16, 16, generator=g, device="cuda") * 10
                 if acc == "random" else torch.zeros(t, 16, 16, device="cuda"))
            o1, o2 = torch.empty_like(c), torch.empty_like(c)
            rc = lib.run(qp.data_ptr(), kp.data_ptr(), c.data_ptr(),
                         fwd.data_ptr(), len(pairs), o1.data_ptr(), t)
            ct = c.transpose(1, 2).contiguous()
            rc |= lib.run(kp.data_ptr(), qp.data_ptr(), ct.data_ptr(),
                          swp.data_ptr(), len(pairs), o2.data_ptr(), t)
            if rc:
                raise SystemExit(f"symmetry launch failed: CUDA error {rc}")
            torch.cuda.synchronize()
            # the 8 x 8 elements both products hold
            same = (o1[:, :8, :8] == o2.transpose(1, 2)[:, :8, :8])
            out[f"mma.sync, {label}, {acc} accumulator"] = \
                same.float().mean().item()
        # the same products with q's rows moved by 8 in the fragment
        moved = qp.view(t, 3, 2, 8, 16).flip(2).reshape(t, 3, 16, 16)
        cm = c.view(t, 2, 8, 16).flip(1).reshape(t, 16, 16).contiguous()
        o3 = torch.empty_like(c)
        lib.run(moved.contiguous().data_ptr(), kp.data_ptr(), cm.data_ptr(),
                fwd.data_ptr(), len(pairs), o3.data_ptr(), t)
        lib.run(qp.data_ptr(), kp.data_ptr(), c.data_ptr(), fwd.data_ptr(),
                len(pairs), o1.data_ptr(), t)
        torch.cuda.synchronize()
        back = o3.view(t, 2, 8, 16).flip(1).reshape(t, 16, 16)
        out[f"mma.sync, {label}, rows moved by 8"] = \
            (back == o1).float().mean().item()
    for key, frac in out.items():
        print(f"symmetry, {key}: {frac:.6f} of the elements bitwise "
              f"equal ({trials} trials)")
    return out


def one_logit(torch, src_dir: Path):
    """dq and dk at a window of 1 (each row sees its own key only), for
    every wide instance of the tree: exactly 0 where every logit of the
    keys kernel has the rows kernel's bits."""
    from repro_torch.kernels.flash_attention import attention_backward
    from repro_torch.kernels.flash_attention import flash_attention as fa
    heads = sys.modules[fa.__module__].BWD_HEAD_DIMS
    out = {}
    for d in WIDE:
        if d not in heads:
            continue
        for dtype in (torch.float32, torch.bfloat16):
            shape = ("one_logit", 2, 300, 4, 2, d, 1, 0.0, "smollm-135m")
            q, k, v, do, st = inputs(torch, shape, dtype, seed=d)
            for softcap in (0.0, 30.0):
                dq, dk, _ = attention_backward(q, k, v, st, do, round_p=True,
                                               window=1, softcap=softcap)
                torch.cuda.synchronize()
                key = (f"d{d}_{str(dtype).split('.')[1]}"
                       f"{'_softcap' if softcap else ''}")
                out[key] = dict(dq_nonzero=int((dq != 0).sum()),
                                dk_nonzero=int((dk != 0).sum()),
                                source=source_of(src_dir, d))
                print(f"one logit, {key} [{out[key]['source']}]: dq nonzero "
                      f"{out[key]['dq_nonzero']}, dk nonzero "
                      f"{out[key]['dk_nonzero']} (of {dq.numel()}, "
                      f"{dk.numel()})", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--symmetry", action="store_true")
    ap.add_argument("--only", nargs="*", default=None)
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "results" / "torch" / "fa_bwd.json")
    args = ap.parse_args()
    src_dir = args.src.resolve()
    sys.path.insert(0, str(src_dir))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_fa_bwd.py needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; src {src_dir}")
    shapes = [s for s in SHAPES if not args.only or s[0] in args.only]
    res = dict(card=card, src=str(src_dir), shapes=shapes,
               times=times(torch, src_dir, shapes))
    if args.probe:
        res["probe"] = probe(torch, src_dir, shapes)
    if args.symmetry:
        res["symmetry"] = symmetry(torch)
        res["one_logit"] = one_logit(torch, src_dir)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
