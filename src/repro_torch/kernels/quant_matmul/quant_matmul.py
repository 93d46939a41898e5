"""Matrix product with packed low-bit weights: the wrapper of the CUDA
kernel in ``repro_torch/csrc/quant_matmul.cu`` (which replaces the Pallas
kernel ``repro.kernels.quant_matmul.quant_matmul``).

A CUDA tensor launches the kernel, or raises: there is no fallback.  A
CPU tensor takes the plain torch version in ``ref.py``, which the kernel
is held to on the card.  ``quant_matmul.launches`` counts kernel
launches.

``plan`` is the launch plan, computed here so that the CPU tests can hold
it to the shapes: M <= 16 runs the split-K GEMV, M > 16 the bf16
tensor-core product; each call is one launch either way.

``cast=torch.bfloat16`` computes the reference's ``qdense`` under a
bfloat16 compute type, ``x.astype(bf16) @ dequant(w).astype(bf16)``: x
and every dequantized weight (code value x the column's factor) rounded
to bfloat16, float32 sums, the result rounded to bfloat16 (both kernels
take it as a launch argument; the prefill product then multiplies one
bf16 part of x, not three).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.quant_matmul.ref import ref_quant_matmul

_MODES = {"int4": 0, "pow2": 1, "int8": 2}
_X_TYPES = {torch.float32: 0, torch.bfloat16: 1}
_VARIANTS = {"gemv": 0, "mma": 1}

GEMV_MAX_M = 16
GEMV_THREADS = 128
GEMV_SMEM_FLOATS = 8192      # kGemvSmem: the x chunk of a block
GEMV_LOADS = 2               # code loads a thread should need, at most
MMA_BM, MMA_BN, MMA_BK = 64, 64, 32
MMA_BLOCKS_PER_SM = 3        # split K until about this many blocks an SM
MMA_MIN_SPAN = 3             # K tiles a split keeps at least
SMS = 132                    # streaming multiprocessors of an H100 SXM
MAX_SPLITS = 8               # a portable cluster size


class Plan(NamedTuple):
    """One launch of ``csrc/quant_matmul.cu``.

    variant "gemv": vec = bytes of a code load (16, 8, 4 or 1; columns a
    thread), tile = threads along N, span = byte rows of a split (K/2 for
    int4/pow2, K for int8).  variant "mma": vec = 16 for cp.async copies,
    0 for element loads; tile = 64, the output tile's columns; span = K
    tiles of 32 of a split.  splits = the cluster's blocks along K; grid =
    the launch's blocks (x, y, z)."""
    variant: str
    vec: int
    tile: int
    splits: int
    span: int
    grid: tuple


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _pow2_floor(v: int) -> int:
    return 1 << (max(v, 1).bit_length() - 1)


def alignment(address: int, pitch: int) -> int:
    """The largest power of two <= 16 dividing both a base address and a
    row pitch, in bytes: every row then starts on that boundary."""
    a = 16
    while a > 1 and (address % a or pitch % a):
        a //= 2
    return a


@functools.lru_cache(maxsize=4096)
def plan(m: int, k: int, n: int, mode: str, *, code_align: int = 16,
         x_align: bool = True) -> Plan:
    """The launch plan for y (m, n) = x (m, k) @ dequant(codes).

    code_align: ``alignment`` of the codes' address and row pitch (N
    bytes); x_align: x's rows are 16-byte aligned (address and K times the
    element size)."""
    if m <= GEMV_MAX_M:
        mb = 4 if m <= 4 else 8 if m <= 8 else 16
        vec = min(64 // mb, code_align)       # columns x rows <= 64
        vec = 1 if vec == 2 else vec
        groups = n // vec
        rows = k if mode == "int8" else k // 2
        tn = min(32, max(4, _pow2_floor(groups // 8)),
                 1 << (groups - 1).bit_length())
        tk = GEMV_THREADS // tn
        splits = next((s for s in range(1, MAX_SPLITS + 1)
                       if _ceil(_ceil(rows, s), tk) <= GEMV_LOADS),
                      MAX_SPLITS)
        span = _ceil(rows, splits)
        splits = _ceil(rows, span)            # no empty split
        return Plan("gemv", vec, tn, splits, span,
                    (_ceil(n, tn * vec), splits, 1))
    bn = MMA_BN
    tiles = _ceil(k, MMA_BK)
    blocks = _ceil(m, MMA_BM) * _ceil(n, bn)
    splits = max(1, min(MAX_SPLITS, _ceil(MMA_BLOCKS_PER_SM * SMS, blocks),
                        tiles // MMA_MIN_SPAN))
    span = _ceil(tiles, splits)
    splits = _ceil(tiles, span)
    vec = 16 if (x_align and code_align == 16) else 0
    return Plan("mma", vec, bn, splits, span,
                (_ceil(n, bn), _ceil(m, MMA_BM), splits))


def plan_ranges(p: Plan, m: int, k: int, n: int, mode: str):
    """The (m, k, n) indices each unit of work of ``p`` covers, per axis,
    by the kernels' own index formulas; the work is their product.  Each
    axis is covered exactly once when its lists concatenate to
    range(size) without repeats."""
    if p.variant == "gemv":
        kpb = 1 if mode == "int8" else 2
        rows = k // kpb
        tk = GEMV_THREADS // p.tile
        mb = 4 if m <= 4 else 8 if m <= 8 else 16
        chunk = GEMV_SMEM_FLOATS // (mb * kpb)
        ns = [range(n0, n0 + p.vec)
              for bx in range(p.grid[0]) for ti in range(p.tile)
              if (n0 := (bx * p.tile + ti) * p.vec) < n]
        ks = []
        for s in range(p.splits):
            r0, r1 = s * p.span, min(rows, (s + 1) * p.span)
            for c0 in range(r0, r1, chunk):
                c1 = min(r1, c0 + chunk)
                for tr in range(tk):
                    ks.append([r * kpb + h for r in range(c0 + tr, c1, tk)
                               for h in range(kpb)])
        return [range(m)], ks, ns
    tiles = _ceil(k, MMA_BK)
    ms = [range(by * MMA_BM, min(m, (by + 1) * MMA_BM))
          for by in range(p.grid[1])]
    ns = [range(bx * p.tile, min(n, (bx + 1) * p.tile))
          for bx in range(p.grid[0])]
    ks = [range(t * MMA_BK, min(k, (t + 1) * MMA_BK))
          for s in range(p.splits)
          for t in range(s * p.span, min(tiles, (s + 1) * p.span))]
    return ms, ks, ns


@functools.lru_cache(maxsize=None)
def _entry():
    fn = _build.load("quant_matmul").quant_matmul_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
           mode: str):
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(f"quant_matmul needs a 2-D x and a 2-D weight, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    packed = mode in ("int4", "pow2")
    want = torch.uint8 if packed else torch.int8
    if w.dtype != want:
        raise ValueError(f"quant_matmul {mode} needs {want} codes, got "
                         f"{w.dtype}")
    k_w = w.shape[0] * (2 if packed else 1)
    if x.shape[1] != k_w:
        raise ValueError(f"quant_matmul {mode}: x has K={x.shape[1]} but the "
                         f"codes {tuple(w.shape)} hold K={k_w}")
    n = w.shape[1]
    if scale.dtype != torch.float32 or tuple(scale.shape) != (n,):
        raise ValueError(f"quant_matmul needs a float32 scale of shape "
                         f"({n},), got {scale.dtype} {tuple(scale.shape)}")


def launch_plan(x: torch.Tensor, w: torch.Tensor, mode: str) -> Plan:
    """The plan of ``quant_matmul(x, w, ...)`` for these tensors, their
    addresses included (a layer's view into stacked codes may start off a
    16-byte boundary)."""
    m, k = x.shape
    n = w.shape[1]
    return plan(m, k, n, mode, code_align=alignment(w.data_ptr(), n),
                x_align=alignment(x.data_ptr(), k * x.element_size()) == 16)


def quant_matmul(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor, *,
                 mode: str = "int4", cast=None) -> torch.Tensor:
    """y = x @ dequant(w), float32.

    x: (M, K) float32 or bfloat16.
    w: int4/pow2 -> (K//2, N) uint8 packed codes; int8 -> (K, N) int8.
    scale: (N,) float32 -- the step (int4/int8) or e_max (pow2).
    Any M, K (even for packed codes) and N; the output is a new tensor.
    cast: None, or torch.bfloat16: x and each dequantized weight rounded
    to bfloat16 before the product, the (M, N) result bfloat16.
    """
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode}")
    if cast not in (None, torch.bfloat16):
        raise ValueError(f"quant_matmul casts to bfloat16 only, got {cast}")
    _check(x, w, scale, mode)
    if cast is not None:
        x = x.to(cast)
    if x.device.type == "cpu":
        return ref_quant_matmul(x, w, scale, mode, cast)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul runs on CUDA or CPU tensors, got "
                         f"{x.device}")
    if x.dtype not in _X_TYPES:
        raise ValueError(f"quant_matmul takes float32 or bfloat16 x, got "
                         f"{x.dtype}")
    for name, t in (("x", x), ("codes", w), ("scale", scale)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"quant_matmul needs {name} contiguous on "
                             f"{x.device}, got {t.device} "
                             f"contiguous={t.is_contiguous()}")
    m, k = x.shape
    n = w.shape[1]
    if max(m, k, n) >= 2 ** 31:
        raise ValueError(f"quant_matmul: shape {(m, k, n)} exceeds int32")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out if cast is None else out.to(cast)
    p = launch_plan(x, w, mode)
    launch = _entry()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = launch(x.data_ptr(), _X_TYPES[x.dtype], w.data_ptr(),
                    scale.data_ptr(), out.data_ptr(), m, k, n, _MODES[mode],
                    _VARIANTS[p.variant], p.vec, p.tile, p.splits, p.span,
                    int(cast is not None), stream)
    if rc != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: CUDA error "
                           f"{rc}")
    quant_matmul.launches += 1
    return out if cast is None else out.to(cast)


quant_matmul.launches = 0

# The reference pads ragged shapes in ``quant_matmul_any``; this kernel
# takes any shape itself, so the name is kept as an alias for API parity.
quant_matmul_any = quant_matmul
