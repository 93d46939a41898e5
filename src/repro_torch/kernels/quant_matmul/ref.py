"""Plain torch versions of the quant_matmul kernel, the port of
``repro.kernels.quant_matmul.ref``: dequantize the whole weight, then an
IEEE float32 matrix product (``ref_quant_matmul``, what the kernel is held
to); and the tensor-core kernel's own arithmetic written out
(``emulate_mma``), so that the CPU can test it."""

from __future__ import annotations

import torch

from repro_torch.quant.pack import DEQUANTIZE, _unpack_k


def ref_quant_matmul(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                     mode: str, cast=None) -> torch.Tensor:
    """x: (M, K) float; w: (K//2, N) uint8 int4/pow2 codes or (K, N) int8;
    scale: (N,) (e_max for pow2) -> (M, N) float32.  ``cast``
    (torch.bfloat16): x and the dequantized weight rounded to it, the
    float32 product rounded to it, as the reference's ``x.astype(ct) @
    w.astype(ct)`` computes it."""
    w = DEQUANTIZE[mode](w, scale)
    if cast is None:
        return x.to(torch.float32) @ w
    f32 = torch.float32
    return (x.to(cast).to(f32) @ w.to(cast).to(f32)).to(cast)


def split_bf16x3(x: torch.Tensor):
    """float32 x as three bfloat16 parts with x == hi + mid + lo exactly
    (round to nearest at each step; three 8-bit significands hold
    float32's 24).  Exceptions: |x| within 2^-8 of FLT_MAX (hi is
    infinite) and |x| below ~2^-110 (lo underflows)."""
    x = x.to(torch.float32)
    hi = x.to(torch.bfloat16)
    r = x - hi.to(torch.float32)
    mid = r.to(torch.bfloat16)
    lo = (r - mid.to(torch.float32)).to(torch.bfloat16)
    return hi, mid, lo


def code_values(w: torch.Tensor, mode: str) -> torch.Tensor:
    """The (K, N) float32 value of every code before its column's factor:
    int4 -8..7, int8 -128..127, pow2 +-2^0..2^7 (each exact in bf16)."""
    if mode == "int8":
        return w.to(torch.float32)
    c = _unpack_k(w).to(torch.int32)
    if mode == "int4":
        return torch.where(c >= 8, c - 16, c).to(torch.float32)
    mag = torch.exp2((c & 7).to(torch.float32))
    return torch.where((c & 8) != 0, -mag, mag)


def column_factor(scale: torch.Tensor, mode: str) -> torch.Tensor:
    """The per-column factor: the scale, or 2^(e_max - 7) for pow2."""
    if mode == "pow2":
        return torch.exp2(scale.to(torch.float32) - 7.0)
    return scale.to(torch.float32)


def emulate_mma(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                mode: str, cast=None) -> torch.Tensor:
    """The prefill kernel's arithmetic: each bf16 part of x (three for
    float32 x, one for bfloat16) times the bf16 code values with float32
    sums, the parts' products added, the factor applied last.  ``cast``
    (torch.bfloat16): x rounded to bf16 (one part) times each code value
    x its factor rounded to bf16, no factor after the sum, the result
    rounded to bf16."""
    if cast is not None:
        vals = (code_values(w, mode) * column_factor(scale, mode)).to(
            torch.bfloat16).to(torch.float32)
        return (x.to(torch.bfloat16).to(torch.float32) @ vals).to(cast)
    vals = code_values(w, mode).to(torch.bfloat16).to(torch.float32)
    parts = split_bf16x3(x) if x.dtype == torch.float32 else (x,)
    y = None
    for p in parts:
        term = p.to(torch.float32) @ vals
        y = term if y is None else y + term
    return y * column_factor(scale, mode)
