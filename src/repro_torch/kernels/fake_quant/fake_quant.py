"""Fused per-channel fake quantization: the wrapper of the CUDA kernel in
``repro_torch/csrc/fake_quant.cu`` (which replaces the Pallas kernel
``repro.kernels.fake_quant.fake_quant``).

A CUDA tensor launches the kernel, or raises: there is no fallback.  A
CPU tensor takes the plain torch version in ``ref.py``, which the kernel
is held to on the card.  A ``meta`` tensor (the dry run) takes the CUDA
branch's checks and allocations and launches nothing.  Under an analyzer
(``launch.op_analysis``, through ``repro_torch._work``) each launch,
after it is made, or its ``meta`` stand-in declares its work (no
products; the bytes it reads and writes).
``fake_quant.launches`` counts kernel launches (of ``fake_quant`` and
``fake_quant_group`` alike).

One launch covers a group of up to ``GROUP_MAX`` tensors of one type:
``plan`` gives each tensor its first block and block count, computed here
so that the CPU tests can hold it to the shapes (``block_ranges`` repeats
the kernel's index arithmetic).  ``fake_quant`` is a group of one.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence

import torch

from repro_torch import _work
from repro_torch.kernels import _build
from repro_torch.kernels.fake_quant.ref import (ref_fake_quant_affine,
                                                ref_fake_quant_pow2)

_MODES = {"affine": 0, "pow2": 1}   # Entry::flags bit 0
_PER_TENSOR = 2                     # Entry::flags bit 1
_TYPES = {torch.float32: 0, torch.bfloat16: 1}

THREADS = 256                # kThreads
UNROLL = 2                   # kUnroll: 16-byte vectors a thread
GROUP_MAX = 64               # kMaxEntries: tensors a launch
MAX_ELEMENTS = 2 ** 31 - 1   # 32-bit element indices


class Part(NamedTuple):
    """One tensor's share of a launch: blocks first_block ..
    first_block + blocks - 1; ``head`` scalar elements come before the
    first 16-byte-aligned one."""
    tensor: int
    first_block: int
    blocks: int
    head: int


def span(elem_size: int) -> int:
    """Elements a block covers (after the head): THREADS x UNROLL
    vectors of 16 bytes."""
    return THREADS * UNROLL * (16 // elem_size)


def head(address: int, elem_size: int, numel: int) -> int:
    """Elements before the first 16-byte-aligned one of a tensor at
    ``address`` (all of them for a tensor shorter than that)."""
    return min((-address % 16) // elem_size, numel)


def plan(numels: Sequence[int], heads: Sequence[int],
         elem_size: int) -> tuple:
    """The launches of a group: a tuple of launches, each a tuple of at
    most GROUP_MAX ``Part``s with first blocks counted from 0.  Empty
    tensors take no part."""
    launches, parts, first = [], [], 0
    step = span(elem_size)
    for t, (n, h) in enumerate(zip(numels, heads)):
        if n == 0:
            continue
        if n > MAX_ELEMENTS:
            raise ValueError(f"fake_quant takes at most {MAX_ELEMENTS} "
                             f"elements a tensor, got {n}")
        if len(parts) == GROUP_MAX:
            launches.append(tuple(parts))
            parts, first = [], 0
        blocks = max(1, -(-(n - h) // step))
        parts.append(Part(t, first, blocks, h))
        first += blocks
    if parts:
        launches.append(tuple(parts))
    return tuple(launches)


def block_ranges(part: Part, numel: int, elem_size: int) -> list:
    """The element ranges each block of ``part`` writes, by the kernel's
    own formulas: per block a list of (lo, hi, kind), kind "vector" for
    16-byte vectors and "scalar" for the head and the tail."""
    vec, step = 16 // elem_size, span(elem_size)
    out = []
    for j in range(part.blocks):
        start = part.head + j * step
        stop = numel if numel - start < step else start + step
        tail = start + (stop - start) // vec * vec
        ranges = [(0, part.head, "scalar")] if j == 0 and part.head else []
        if tail > start:
            ranges.append((start, tail, "vector"))
        if stop > tail:
            ranges.append((tail, stop, "scalar"))
        out.append(ranges)
    return out


class _Entry(ctypes.Structure):
    """csrc/fake_quant.cu's ``Entry``, field for field."""
    _fields_ = [("w", ctypes.c_void_p), ("scale", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("first_block", ctypes.c_int),
                ("numel", ctypes.c_int), ("cols", ctypes.c_int),
                ("head", ctypes.c_int), ("qmax", ctypes.c_float),
                ("flags", ctypes.c_int)]


@functools.lru_cache(maxsize=None)
def _entry():
    lib = _build.load("fake_quant")
    if (lib.fake_quant_entry_bytes() != ctypes.sizeof(_Entry)
            or lib.fake_quant_max_entries() != GROUP_MAX):
        raise RuntimeError("csrc/fake_quant.cu's table layout is not the "
                           "wrapper's")
    fn = lib.fake_quant_group_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _plain(w, scale, mode, bits):
    if mode == "affine":
        return ref_fake_quant_affine(w, scale, bits)
    return ref_fake_quant_pow2(w, scale)


def _check(ws, scales):
    """Raise for what the kernel does not take."""
    dtype, device = ws[0].dtype, ws[0].device
    for w, s in zip(ws, scales):
        if w.dtype not in _TYPES or w.dtype != dtype:
            raise ValueError(f"fake_quant takes float32 or bfloat16 weights, "
                             f"one type a group, got {w.dtype} after {dtype}")
        if w.ndim != 2 or not w.is_contiguous() or w.device != device:
            raise ValueError(f"fake_quant needs contiguous 2-D weights on "
                             f"{device}, got {tuple(w.shape)} contiguous="
                             f"{w.is_contiguous()} on {w.device}")
        n = w.shape[1]
        if (s.dtype != dtype or s.ndim != 1 or s.numel() not in (1, n)
                or not s.is_contiguous() or s.device != device):
            raise ValueError(f"fake_quant needs a contiguous {dtype} scale of "
                             f"shape ({n},) or (1,) on {device}, got "
                             f"{s.dtype} {tuple(s.shape)} on {s.device}")


def fake_quant_group(ws: Sequence[torch.Tensor],
                     scales: Sequence[torch.Tensor], *, mode: str = "affine",
                     bits: int = 8) -> list:
    """``[fake_quant(w, s, mode=mode, bits=bits) for w, s in zip(ws,
    scales)]`` in one launch a GROUP_MAX tensors.  On the card the outputs
    are views into one new buffer, each at its input's offset modulo 16
    bytes."""
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode}")
    ws, scales = list(ws), list(scales)
    if len(ws) != len(scales):
        raise ValueError(f"{len(ws)} weights and {len(scales)} scales")
    if not ws:
        return []
    if any(w.device.type == "cpu" for w in ws):
        if not all(w.device.type == "cpu" for w in ws):
            raise ValueError("fake_quant_group takes tensors of one device")
        return [_plain(w, s, mode, bits) for w, s in zip(ws, scales)]
    if any(w.device.type not in ("cuda", "meta") for w in ws):
        raise ValueError(f"fake_quant runs on CUDA or CPU tensors, got "
                         f"{sorted({str(w.device) for w in ws})}")
    _check(ws, scales)
    dtype, elem = ws[0].dtype, ws[0].element_size()
    meta = ws[0].device.type == "meta"
    heads = [head(_work.address(w), elem, w.numel()) for w in ws]
    launches = plan([w.numel() for w in ws], heads, elem)

    # one buffer; each output at its input's offset modulo 16 bytes
    pad = 16 // elem
    buf = torch.empty(sum(w.numel() for w in ws) + pad * len(ws), dtype=dtype,
                      device=ws[0].device)
    outs, at = [], 0
    for w in ws:
        at += ((_work.address(w) - _work.address(buf) - at * elem) % 16
               // elem)
        outs.append(buf[at:at + w.numel()].view(w.shape))
        at += w.numel()

    if meta:
        for parts in launches:
            _declare(ws, scales, outs, parts)
        return outs
    launch = _entry()
    qmax = 2.0 ** (bits - 1) - 1.0
    with torch.cuda.device(ws[0].device):
        stream = torch.cuda.current_stream(ws[0].device).cuda_stream
        for parts in launches:
            table = (_Entry * len(parts))()
            for e, p in zip(table, parts):
                w, s = ws[p.tensor], scales[p.tensor]
                e.w, e.scale, e.out = (w.data_ptr(), s.data_ptr(),
                                       outs[p.tensor].data_ptr())
                e.first_block, e.numel, e.cols, e.head = (
                    p.first_block, w.numel(), w.shape[1], p.head)
                e.qmax = qmax
                e.flags = _MODES[mode] | (_PER_TENSOR if s.numel() == 1
                                          else 0)
            blocks = parts[-1].first_block + parts[-1].blocks
            rc = launch(ctypes.addressof(table), len(parts), blocks,
                        _TYPES[dtype], stream)
            if rc != 0:
                raise RuntimeError(f"fake_quant kernel launch failed: CUDA "
                                   f"error {rc}")
            fake_quant.launches += 1
            _declare(ws, scales, outs, parts)
    return outs


def _declare(ws, scales, outs, parts) -> None:
    """One launch's work: each tensor and its scale read, its output
    written; no products (nothing without an analyzer)."""
    if _work.active() is None:
        return
    _work.declare(
        "fake_quant", 0,
        [t for p in parts for t in (ws[p.tensor], scales[p.tensor])],
        [outs[p.tensor] for p in parts])


def fake_quant(w: torch.Tensor, scale: torch.Tensor, *, mode: str = "affine",
               bits: int = 8) -> torch.Tensor:
    """Fused quantize-dequantize of w: (K, N) float32 or bfloat16 with
    one value of w's type per column in scale: (N,), or one for the whole
    tensor: (1,); the step for ``mode="affine"``, e_max for
    ``mode="pow2"``.  Any K and N; the output is a new tensor."""
    return fake_quant_group([w], [scale], mode=mode, bits=bits)[0]


fake_quant.launches = 0

# The reference pads ragged shapes in ``fake_quant_any``; this kernel takes
# any (K, N) itself, so the name is kept as an alias for API parity.
fake_quant_any = fake_quant
