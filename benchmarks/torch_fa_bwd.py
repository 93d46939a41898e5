"""The port's attention backward kernel (``csrc/flash_attention_bwd.cu``)
on the card: times, a phase breakdown, and the tensor-core property its
design rests on.

  python3 benchmarks/torch_fa_bwd.py [--probe] [--symmetry]
                                     [--src OTHER/src]
                                     [--out results/torch/fa_bwd.json]

At SmolLM-135M's training shape (16 x 256, GQA 9/3, head_dim 64) in
float32 (the training path's type) and bfloat16, with ``round_p``:
- the kernel's time (one backward: both kernels), SDPA's backward on the
  same inputs, and each kernel's device time from ``torch.profiler``;
  the kernel is held to the plain version first
  (``train_check.attention_grad_errors``).  A time is the mean over 20
  calls queued behind a sleep kernel, so the events see the device only;
- ``--probe``: a copy of the source with ``clock64`` probes between the
  kernels' phases (thread 0 of every block), built beside the real one:
  each phase's share of a block's cycles and its cycles per chunk of keys
  (rows kernel) or tile of rows (keys kernel).  The probes sit on the
  source's ``// PROBE`` comment lines, which the kernel's build ignores;
- ``--src``: the package (and the kernel source the probes read) from
  another checkout's ``src``, its kernels built under that checkout's
  ``build/``: run parent, change, change, parent in one call to compare
  two trees on one card;
- ``--symmetry``: whether ``mma.sync.m16n8k16`` (bf16 in, float32
  accumulators) gives (A B)[i][j] and (B^T A^T)[j][i] with the same bits
  over a chain of bf16 part products, with and without an accumulator,
  and at another place in the fragment: the keys kernel forms S^T where
  the rows kernel forms S, and needs every logit's bits to agree.
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

B, S, HQ, HKV, D = 16, 256, 9, 3, 64
REPS = 20
SLEEP_CYCLES = 100_000_000

ROWS_PHASES = ["prologue", "pass 1 wait", "pass 1 split", "pass 1 copy + S, dP",
               "pass 1 online", "merge", "pass 2 wait + split",
               "pass 2 copy + S, dP", "pass 2 dS + dq", "dq halves"]
KEYS_PHASES = ["prologue", "wait", "split + copy", "S^T, dP^T", "P^T, dS^T",
               "dv, dk"]


def probed_source(src: str) -> str:
    """The kernel's source with its ``// PROBE`` comment lines made code:
    ``PROBE n`` adds the cycles since the last probe to phase n, ``PROBE
    start`` starts the clock, ``PROBE dump <buffer> <phases> <units>``
    writes thread 0's phases, its total cycles and its count of chunks or
    tiles to the block's slot of the buffer."""
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
    marks = re.findall(r"^\s*// PROBE (\S+)", src, flags=re.M)
    want = (["start"] + [str(i) for i in range(10)] + ["dump", "start"]
            + [str(i) for i in range(6)] + ["dump"])
    if marks != want:
        raise SystemExit(f"the kernel's PROBE lines are {marks}, not {want}")
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


def inputs(torch, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((B, S, h, D), generator=g, device="cuda").to(dtype)
               for h in (HQ, HKV, HKV))
    do = torch.randn((B, S, HQ, D), generator=g, device="cuda")
    return q, k, v, do, torch.zeros(B, dtype=torch.int32, device="cuda")


def device_ms(torch, fn):
    for _ in range(3):
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


def times(torch):
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.flash_attention import attention_backward
    from repro_torch.kernels.flash_attention.ref import ref_attention_gqa_bwd
    from repro_torch.train_check import attention_grad_errors
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do, st = inputs(torch, dtype)
        err = attention_grad_errors(
            attention_backward(q, k, v, st, do, round_p=True),
            ref_attention_gqa_bwd(q, k, v, st, do, True, 0.0, True), do)
        if not err["ok"]:
            raise SystemExit(f"backward kernel {dtype}: {err}")
        tq, tk, tv = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        out = sdpa(tq, tk, tv, is_causal=True, enable_gqa=True)
        tdo = do.transpose(1, 2).to(out.dtype)
        kernel = lambda: attention_backward(q, k, v, st, do,  # noqa: E731
                                            round_p=True)
        row = dict(kernel_ms=device_ms(torch, kernel),
                   sdpa_ms=device_ms(torch, lambda: torch.autograd.grad(
                       out, (tq, tk, tv), tdo, retain_graph=True)),
                   max_abs_err=err["max_abs_err"])
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                kernel()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            for name in ("rows_kernel", "keys_kernel"):
                if name in e.key:
                    row[f"{name}_ms"] = e.device_time_total / e.count / 1e3
        rows[str(dtype).split(".")[1]] = row
        print(f"{dtype}: backward {row['kernel_ms']:.4f} ms (rows "
              f"{row.get('rows_kernel_ms', 0):.4f}, keys "
              f"{row.get('keys_kernel_ms', 0):.4f}), SDPA backward "
              f"{row['sdpa_ms']:.4f} ms, max |err| vs plain "
              f"{row['max_abs_err']:.3g}", flush=True)
    return rows


def probe(torch, src_dir: Path):
    src = (src_dir / "repro_torch" / "csrc"
           / "flash_attention_bwd.cu").read_text()
    lib = nvcc(probed_source(src), "fa_bwd_probe")
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                   + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_float]
                   + [ctypes.c_void_p])
    lib.set_dbg.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, do, st = inputs(torch, dtype)
        grads = [torch.empty_like(t) for t in (q, k, v)]
        stats = torch.empty(3 * B * S * HQ, device="cuda")
        bufs = {n: torch.zeros(4096, 16, dtype=torch.int64, device="cuda")
                for n in ("rows", "keys")}
        if lib.set_dbg(bufs["rows"].data_ptr(), bufs["keys"].data_ptr()):
            raise SystemExit("probe: cudaMemcpyToSymbol failed")
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(3):
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                    st.data_ptr(), *(x.data_ptr() for x in grads),
                    stats.data_ptr(), int(dtype == torch.bfloat16), B, S, S,
                    HQ, HKV, D, D ** -0.5, 1, 1, 0, 0.0, stream)
            if rc:
                raise SystemExit(f"probe launch failed: CUDA error {rc}")
        torch.cuda.synchronize()
        tag = str(dtype).split(".")[1]
        for name, names, blocks in (("rows", ROWS_PHASES, HKV * B * 12),
                                    ("keys", KEYS_PHASES, HKV * B * 4)):
            x = bufs[name][:blocks].double().cpu()
            total, units = x[:, 10], x[:, 11]
            row = dict(blocks=blocks, cycles_mean=total.mean().item(),
                       cycles_max=total.max().item(),
                       units_mean=units.mean().item(), phases={})
            for i, ph in enumerate(names):
                row["phases"][ph] = dict(
                    share=(x[:, i].sum() / total.sum()).item(),
                    cycles_per_unit=(x[:, i].sum() / units.sum()).item())
            out[f"{tag}/{name}"] = row
            print(f"{tag} {name} kernel: {blocks} blocks, "
                  f"{row['cycles_mean']:.0f} cycles a block (max "
                  f"{row['cycles_max']:.0f}), {row['units_mean']:.2f} "
                  f"{'chunks' if name == 'rows' else 'tiles'} a block")
            for ph, r in row["phases"].items():
                print(f"    {ph:22s} {r['share'] * 100:5.1f}%  "
                      f"{r['cycles_per_unit']:8.0f} cycles a unit")
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
            out[f"{label}, {acc} accumulator"] = same.float().mean().item()
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
        out[f"{label}, rows moved by 8"] = (back == o1).float().mean().item()
    for key, frac in out.items():
        print(f"mma symmetry, {key}: {frac:.6f} of the elements bitwise "
              f"equal ({trials} trials)")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--symmetry", action="store_true")
    ap.add_argument("--src", type=Path, default=ROOT / "src")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "results" / "torch" / "fa_bwd.json")
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_fa_bwd.py needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; src {args.src}")
    res = dict(card=card, src=str(args.src), shape=[B, S, HQ, HKV, D],
               times=times(torch))
    if args.probe:
        res["probe"] = probe(torch, args.src)
    if args.symmetry:
        res["symmetry"] = symmetry(torch)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
